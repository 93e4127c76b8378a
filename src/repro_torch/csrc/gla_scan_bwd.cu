// Backward of the chunked gated linear attention (GLA) scan for Hopper
// (sm_90a), on CUDA cores.
//
// The JAX package has no Pallas backward: jax.grad differentiates through
// gla_scan_xla, whose forward gla_scan_pallas / _gla_kernel replaces
// (src/repro/kernels/ssm_scan/kernel.py:76).  This computes that gradient,
// what gla_scan_bwd_ref (kernels/ssm_scan/ref.py) computes, from a zero
// initial state, given dO and the final state's gradient dS_n (or zero).
// Per chunk c of C positions, with w <- clip(w, -30, 0), a = cumsum(w)
// within the chunk, q~ = q e^a, k~ = k e^min(-a, 60), e = e^{a_last}, S_c
// the state at the chunk's start and dS the gradient of the state after it:
//   dP  = mask(dO v^T);   P = mask(q~ k~^T)
//   dq~ = dP k~ + dO S_c^T;            dq = dq~ e^a
//   dk~ = dP^T q~ + e (v dS^T);        dk = dk~ e^min(-a, 60)
//   dv  = P^T dO + (k~ e) dS
//   da  = dq~ q~ - dk~ k~ [guard], plus e (sum_v S_c dS + sum_i k~ (v dS^T))
//         on the chunk's last row
//   dw  = reverse cumsum of da within the chunk, times [clip]
//   dS_c = q~^T dO + e dS      (the gradient carried to the chunk before)
// [guard] and [clip] are the derivatives of min(-a, 60) and of the clip,
// one half at a tie (-a == 60, w == 0, w == -30), as jax.grad gives them.
//
// Layout.  Only the two state recurrences are sequential over chunks, and
// neither needs the other: S_c runs forward from zero, dS_{c+1} backward
// from dS_n.  So four kernels run in order on one stream:
//   1. scan, forward: one block per (batch * head, V tile, K tile) walks
//      the chunks in order, keeps its slice of S in registers and writes
//      S_c for every chunk to the workspace `states` (B, H, n, K, V);
//   2. scan, reverse: the same walk from the last chunk, writing dS_{c+1}
//      to `dstates` (B, H, n, K, V);
//   3. dqk: one block per (batch * head, chunk, K tile of at most 64)
//      forms dP (streaming dO and v through shared memory 16 columns at a
//      time), dO S_c^T and v dS^T the same way, then dq, dk and dw;
//   4. dv: one block per (batch * head, chunk, V tile of at most 64) forms
//      P and (k~ e) dS (streaming q, k and w 32 key columns at a time),
//      then dv.
// Kernels 3 and 4 are independent over chunks: at B 8, H 64, S 2048, chunk
// 128 that is 8192 blocks each.  Each holds a C x C score tile in shared
// memory and its threads own 8 x 8 register tiles of it (rows ty + 16 m,
// columns tx + 16 n of a 16 x 16 thread grid); the causal mask is a zero
// in that tile, and rows at or past S are staged as zeros (the plain
// version's padding: w = 0 there, so e is the last real row's).  Every sum
// is an fp32 FMA in a fixed order and nothing is atomic, so two calls give
// the same bits.  The decay's running sum is one thread per key column over
// the chunk's rows, after every thread has staged the rows in parallel.
//
// Bound.  At RWKV6's training shape (B 8, H 64, S 2048, K = V = 64, bf16)
// the bytes it must move (q, k, v, dO and w read, dq, dk, dv and dw
// written: 1.48 GB) bind an H100 at 0.44 ms, above the chunked form's 86
// GFLOP at the bf16 tensor-core rate (0.09 ms; 1.29 ms at the fp32 rate).
// This first version does those products as fp32 FMAs on CUDA cores out
// of shared memory, reads the inputs again in kernels 1-4 and round-trips
// the two workspaces (2 x 134 MB there): its real limits are the CUDA
// cores' rate, shared-memory traffic and one block an SM (kernels 3 and 4
// use 192 and 154 KiB of shared memory at C = 128).  The tensor-core
// redesign is a later step.
//
// Strides.  q, k, v, w and dO arrive as (B, H, S, *) views with any strides
// for B, H and S and a contiguous last axis, except that w's K axis may
// have stride 0 (Mamba2: one decay per head).  dS_n, dq, dk, dv, dw and the
// workspaces are contiguous.

#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 256;
constexpr int kMaxC = 128;      // the largest chunk
constexpr int kTile = 16;       // threads as a 16 x 16 grid over a tile
constexpr int kRows = kMaxC / kTile;  // rows of a tile a thread owns (8)
constexpr int kVS = 16;         // columns of dO and v staged at a time (dqk)
constexpr float kClamp = 30.f;  // w is clipped to [-kClamp, 0]
constexpr float kGuard = 60.f;  // exp(-a) saturates at e^kGuard

struct Strides {
  long long b, h, s, k;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* w;
  const float* d_final;  // (B, H, K, V) or null (zero)
  void* dq;
  void* dk;
  void* dv;
  float* dw;
  float* states;   // (B, H, n, K, V): S_c
  float* dstates;  // (B, H, n, K, V): dS_{c+1}
  int H, S, K, V, C, n;
  Strides sq, sk, sv, sw, sd;
};

__device__ __forceinline__ float clip_w(float w) { return fminf(fmaxf(w, -kClamp), 0.f); }

// d clip(w, -30, 0) / dw, one half at either bound.
__device__ __forceinline__ float clip_grad(float w) {
  return (w > -kClamp && w < 0.f) ? 1.f : (w == -kClamp || w == 0.f) ? 0.5f : 0.f;
}

// d min(-a, 60) / d(-a), one half at the tie.
__device__ __forceinline__ float guard_grad(float neg_a) {
  return neg_a < kGuard ? 1.f : neg_a == kGuard ? 0.5f : 0.f;
}

// ---------------------------------------------------------------------------
// Kernels 1 and 2: the state recurrences.
// ---------------------------------------------------------------------------

// Forward (kReverse false): out[c] = S_c, then S <- e S + (k~ e)^T v.
// Reverse: out[c] = dS_{c+1} (d_final or zero after the last chunk), then
// dS <- q~^T dO + e dS.  Columns of S are independent in both K and V, so a
// block takes a KT x VT slice; the thread with (grp, vcol) owns rows grp +
// r * kGroups of column vcol in registers.
inline size_t scan_smem(int KT, int VT, int C) {
  return ((size_t)2 * C * (KT + 1) + (size_t)C * VT + KT) * sizeof(float);
}

template <typename T, int KT, int VT, bool kReverse>
__global__ void __launch_bounds__(kThreads) gla_bwd_scan_kernel(BwdArgs p) {
  constexpr int KP = KT + 1;
  constexpr int kGroups = kThreads / VT;
  constexpr int kKeysPer = KT * VT / kThreads;
  static_assert(kKeysPer >= 1, "tile too small for the block");
  const int C = p.C, S = p.S, K = p.K, V = p.V;
  extern __shared__ float smem[];
  float* x_s = smem;           // [C][KP]: k (forward) or q (reverse), then k~ or q~
  float* w_s = x_s + C * KP;   // [C][KP]: clip(w)
  float* y_s = w_s + C * KP;   // [C][VT]: v (forward) or dO (reverse)
  float* ea_s = y_s + C * VT;  // [KT]: e^{a_last}

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int v0 = blockIdx.y * VT, k0 = blockIdx.z * KT;
  const int tid = threadIdx.x, vcol = tid % VT, grp = tid / VT;
  const Strides sx = kReverse ? p.sq : p.sk;
  const Strides sy = kReverse ? p.sd : p.sv;
  const T* xb = static_cast<const T*>(kReverse ? p.q : p.k) + b * sx.b + h * sx.h + k0;
  const T* yb = static_cast<const T*>(kReverse ? p.dout : p.v) + b * sy.b + h * sy.h + v0;
  const float* wb = p.w + b * p.sw.b + h * p.sw.h + k0 * p.sw.k;
  float* out = (kReverse ? p.dstates : p.states) + (size_t)bh * p.n * K * V;

  float st[kKeysPer];
#pragma unroll
  for (int r = 0; r < kKeysPer; ++r) {
    const int kk = k0 + grp + r * kGroups;
    st[r] = (kReverse && p.d_final) ? p.d_final[((size_t)bh * K + kk) * V + v0 + vcol] : 0.f;
  }
  for (int step = 0; step < p.n; ++step) {
    const int c = kReverse ? p.n - 1 - step : step;
    const int c0 = c * C, rows = min(C, S - c0);
#pragma unroll
    for (int r = 0; r < kKeysPer; ++r) {
      const int kk = k0 + grp + r * kGroups;
      out[((size_t)c * K + kk) * V + v0 + vcol] = st[r];
    }
    if (step == p.n - 1) break;  // the state past the last chunk walked is not needed
    for (int idx = tid; idx < rows * KT; idx += kThreads) {
      const int i = idx / KT, kk = idx % KT;
      const long long pos = c0 + i;
      w_s[i * KP + kk] = clip_w(wb[pos * p.sw.s + kk * p.sw.k]);
      x_s[i * KP + kk] = to_float(xb[pos * sx.s + kk]);
    }
    for (int idx = tid; idx < rows * VT; idx += kThreads) {
      const int i = idx / VT, j = idx % VT;
      y_s[i * VT + j] = to_float(yb[(c0 + i) * sy.s + j]);
    }
    __syncthreads();
    if (tid < KT) {
      float a = 0.f;
      for (int i = 0; i < rows; ++i) {
        a += w_s[i * KP + tid];
        x_s[i * KP + tid] *= kReverse ? expf(a) : expf(fminf(-a, kGuard));
      }
      ea_s[tid] = expf(a);
    }
    __syncthreads();
    float acc[kKeysPer];
#pragma unroll
    for (int r = 0; r < kKeysPer; ++r) acc[r] = 0.f;
    for (int j = 0; j < rows; ++j) {
      const float y = y_s[j * VT + vcol];
#pragma unroll
      for (int r = 0; r < kKeysPer; ++r) {
        const int kk = grp + r * kGroups;
        const float x = kReverse ? x_s[j * KP + kk] : x_s[j * KP + kk] * ea_s[kk];
        acc[r] += x * y;
      }
    }
#pragma unroll
    for (int r = 0; r < kKeysPer; ++r) st[r] = st[r] * ea_s[grp + r * kGroups] + acc[r];
    __syncthreads();  // x, y and e are consumed
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: dq, dk and dw of one chunk and K tile.
// ---------------------------------------------------------------------------

inline size_t dqk_smem(int KT, int C) {
  return ((size_t)3 * C * (KT + 1) + (size_t)C * (C + 1) + (size_t)2 * C * (kVS + 1)
          + (size_t)2 * KT * (kVS + 1) + (size_t)kTile * KT + 2 * KT) * sizeof(float);
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads) gla_bwd_dqk_kernel(BwdArgs p) {
  constexpr int KP = KT + 1, VP = kVS + 1;
  constexpr int NK = KT / kTile;  // key columns of a tile a thread owns
  const int C = p.C, CP = C + 1, S = p.S, K = p.K, V = p.V;
  extern __shared__ float smem[];
  float* qt_s = smem;                // [C][KP]: q, then q~
  float* kt_s = qt_s + C * KP;       // [C][KP]: k, then k~
  float* a_s = kt_s + C * KP;        // [C][KP]: clip(w), a, da, its reverse cumsum
  float* dp_s = a_s + C * KP;        // [C][CP]: dP
  float* do_s = dp_s + C * CP;       // [C][VP]: kVS columns of dO
  float* v_s = do_s + C * VP;        // [C][VP]: the same columns of v
  float* s_s = v_s + C * VP;         // [KT][VP]: the same columns of S_c
  float* g_s = s_s + KT * VP;        // [KT][VP]: ... and of dS
  float* red_s = g_s + KT * VP;      // [kTile][KT]: partial sums of k~ (v dS^T)
  float* ea_s = red_s + kTile * KT;  // [KT]: e^{a_last}
  float* sg_s = ea_s + KT;           // [KT]: sum_v S_c dS

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int c = blockIdx.y, c0 = c * C, rows = min(C, S - c0);
  const int k0 = blockIdx.z * KT;
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h + k0;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h + k0;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* db = static_cast<const T*>(p.dout) + b * p.sd.b + h * p.sd.h;
  const float* wb = p.w + b * p.sw.b + h * p.sw.h + k0 * p.sw.k;
  const size_t st_off = (((size_t)bh * p.n + c) * K + k0) * V;
  const float* sc = p.states + st_off;
  const float* gc = p.dstates + st_off;

  // 1. q, k and clip(w) of the chunk's rows; zero past the sequence.
  for (int idx = tid; idx < C * KT; idx += kThreads) {
    const int i = idx / KT, kk = idx % KT;
    const long long pos = c0 + i;
    const bool in = i < rows;
    qt_s[i * KP + kk] = in ? to_float(qb[pos * p.sq.s + kk]) : 0.f;
    kt_s[i * KP + kk] = in ? to_float(kb[pos * p.sk.s + kk]) : 0.f;
    a_s[i * KP + kk] = in ? clip_w(wb[pos * p.sw.s + kk * p.sw.k]) : 0.f;
  }
  __syncthreads();
  // 2. a, q~ and k~, one thread per key column (read again after step 3's
  //    barriers).
  if (tid < KT) {
    float a = 0.f;
    for (int i = 0; i < rows; ++i) {
      a += a_s[i * KP + tid];
      a_s[i * KP + tid] = a;
      qt_s[i * KP + tid] *= expf(a);
      kt_s[i * KP + tid] *= expf(fminf(-a, kGuard));
    }
    ea_s[tid] = expf(a);
  }

  // 3. dP = dO v^T over V, kVS columns at a time.
  {
    float acc[kRows][kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int n = 0; n < kRows; ++n) acc[m][n] = 0.f;
    for (int v0 = 0; v0 < V; v0 += kVS) {
      for (int idx = tid; idx < C * kVS; idx += kThreads) {
        const int i = idx / kVS, j = idx % kVS;
        const bool in = i < rows;
        do_s[i * VP + j] = in ? to_float(db[(c0 + i) * p.sd.s + v0 + j]) : 0.f;
        v_s[i * VP + j] = in ? to_float(vb[(c0 + i) * p.sv.s + v0 + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kVS; ++j) {
        float x[kRows], y[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const int i = ty + kTile * m;
          x[m] = i < C ? do_s[i * VP + j] : 0.f;
          const int jj = tx + kTile * m;
          y[m] = jj < C ? v_s[jj * VP + j] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
          for (int n = 0; n < kRows; ++n) acc[m][n] += x[m] * y[n];
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int n = 0; n < kRows; ++n) {
        const int i = ty + kTile * m, j = tx + kTile * n;
        if (i < C && j < C) dp_s[i * CP + j] = j <= i ? acc[m][n] : 0.f;
      }
  }

  // 4. r = dO S_c^T and u = v dS^T (rows ty + 16 m, key columns tx + 16 n)
  //    and sum_v S_c dS, over V the same way.
  float r[kRows][NK], u[kRows][NK];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int n = 0; n < NK; ++n) r[m][n] = u[m][n] = 0.f;
  float sg = 0.f;
  for (int v0 = 0; v0 < V; v0 += kVS) {
    for (int idx = tid; idx < C * kVS; idx += kThreads) {
      const int i = idx / kVS, j = idx % kVS;
      const bool in = i < rows;
      do_s[i * VP + j] = in ? to_float(db[(c0 + i) * p.sd.s + v0 + j]) : 0.f;
      v_s[i * VP + j] = in ? to_float(vb[(c0 + i) * p.sv.s + v0 + j]) : 0.f;
    }
    for (int idx = tid; idx < KT * kVS; idx += kThreads) {
      const int kk = idx / kVS, j = idx % kVS;
      s_s[kk * VP + j] = sc[(size_t)kk * V + v0 + j];
      g_s[kk * VP + j] = gc[(size_t)kk * V + v0 + j];
    }
    __syncthreads();
    if (tid < KT)
      for (int j = 0; j < kVS; ++j) sg += s_s[tid * VP + j] * g_s[tid * VP + j];
#pragma unroll 4
    for (int j = 0; j < kVS; ++j) {
      float d[kRows], vv[kRows], s[NK], g[NK];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = ty + kTile * m;
        d[m] = i < C ? do_s[i * VP + j] : 0.f;
        vv[m] = i < C ? v_s[i * VP + j] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s[n] = s_s[(tx + kTile * n) * VP + j];
        g[n] = g_s[(tx + kTile * n) * VP + j];
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          r[m][n] += d[m] * s[n];
          u[m][n] += vv[m] * g[n];
        }
    }
    __syncthreads();
  }
  if (tid < KT) sg_s[tid] = sg;

  // 5. dq~ = r + dP k~ (into r) and dP^T q~ (into dkt); dP is zero above
  //    the diagonal and on rows past the sequence.
  float dkt[kRows][NK];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int n = 0; n < NK; ++n) dkt[m][n] = 0.f;
  for (int j = 0; j < C; ++j) {
    float kj[NK], qj[NK], pr[kRows], pc[kRows];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      kj[n] = kt_s[j * KP + tx + kTile * n];
      qj[n] = qt_s[j * KP + tx + kTile * n];
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = ty + kTile * m;
      pr[m] = i < C ? dp_s[i * CP + j] : 0.f;  // dP[i][j]
      pc[m] = i < C ? dp_s[j * CP + i] : 0.f;  // dP[j][i]
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        r[m][n] += pr[m] * kj[n];
        dkt[m][n] += pc[m] * qj[n];
      }
  }

  // 6. dq, dk, and da over a (each thread reads and writes only its own
  //    elements of a_s there); partial sums of k~ (v dS^T) by column.
  T* dqb = static_cast<T*>(p.dq) + ((size_t)bh * S + c0) * K + k0;
  T* dkb = static_cast<T*>(p.dk) + ((size_t)bh * S + c0) * K + k0;
  float part[NK];
#pragma unroll
  for (int n = 0; n < NK; ++n) part[n] = 0.f;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = ty + kTile * m;
    if (i >= rows) continue;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int kk = tx + kTile * n;
      const float a = a_s[i * KP + kk];
      const float dq_t = r[m][n];
      const float dk_t = dkt[m][n] + ea_s[kk] * u[m][n];
      dqb[(size_t)i * K + kk] = from_float<T>(dq_t * expf(a));
      dkb[(size_t)i * K + kk] = from_float<T>(dk_t * expf(fminf(-a, kGuard)));
      a_s[i * KP + kk] = dq_t * qt_s[i * KP + kk] - dk_t * kt_s[i * KP + kk] * guard_grad(-a);
      part[n] += kt_s[i * KP + kk] * u[m][n];
    }
  }
#pragma unroll
  for (int n = 0; n < NK; ++n) red_s[ty * KT + tx + kTile * n] = part[n];
  __syncthreads();

  // 7. The reverse cumsum of da by column, from the last row's extra term
  //    e (sum_v S_c dS + sum_i k~ (v dS^T)).
  if (tid < KT) {
    float acc = 0.f;
    for (int t = 0; t < kTile; ++t) acc += red_s[t * KT + tid];
    acc = ea_s[tid] * (sg_s[tid] + acc);
    for (int i = rows - 1; i >= 0; --i) {
      acc += a_s[i * KP + tid];
      a_s[i * KP + tid] = acc;
    }
  }
  __syncthreads();

  // 8. dw: that times the clip's derivative.
  for (int idx = tid; idx < rows * KT; idx += kThreads) {
    const int i = idx / KT, kk = idx % KT;
    const long long pos = c0 + i;
    p.dw[((size_t)bh * S + pos) * K + k0 + kk] =
        a_s[i * KP + kk] * clip_grad(wb[pos * p.sw.s + kk * p.sw.k]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: dv of one chunk and V tile.
// ---------------------------------------------------------------------------

inline size_t dv_smem(int VT, int KS, int C) {
  return ((size_t)C * (C + 1) + (size_t)3 * C * (KS + 1) + (size_t)KS * VT + KS
          + (size_t)C * VT) * sizeof(float);
}

template <typename T, int VT, int KS>
__global__ void __launch_bounds__(kThreads) gla_bwd_dv_kernel(BwdArgs p) {
  constexpr int KP = KS + 1;
  constexpr int NV = VT / kTile;  // value columns of a tile a thread owns
  const int C = p.C, CP = C + 1, S = p.S, K = p.K, V = p.V;
  extern __shared__ float smem[];
  float* p_s = smem;             // [C][CP]: P = mask(q~ k~^T)
  float* qt_s = p_s + C * CP;    // [C][KP]: KS key columns of q, then q~
  float* kt_s = qt_s + C * KP;   // [C][KP]: ... of k, then k~
  float* a_s = kt_s + C * KP;    // [C][KP]: ... of clip(w)
  float* g_s = a_s + C * KP;     // [KS][VT]: those rows of dS, this V tile
  float* ea_s = g_s + KS * VT;   // [KS]: e^{a_last}
  float* do_s = ea_s + KS;       // [C][VT]: dO, this V tile

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int c = blockIdx.y, c0 = c * C, rows = min(C, S - c0);
  const int v0 = blockIdx.z * VT;
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* db = static_cast<const T*>(p.dout) + b * p.sd.b + h * p.sd.h + v0;
  const float* wb = p.w + b * p.sw.b + h * p.sw.h;
  const float* gc = p.dstates + ((size_t)bh * p.n + c) * K * V + v0;

  float acc[kRows][kRows];  // P[ty + 16 m][tx + 16 n]
  float t[kRows][NV];       // dv[ty + 16 m][tx + 16 n]
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int n = 0; n < kRows; ++n) acc[m][n] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) t[m][n] = 0.f;
  }
  for (int ks = 0; ks < K; ks += KS) {
    for (int idx = tid; idx < C * KS; idx += kThreads) {
      const int i = idx / KS, kk = idx % KS;
      const long long pos = c0 + i;
      const bool in = i < rows;
      qt_s[i * KP + kk] = in ? to_float(qb[pos * p.sq.s + ks + kk]) : 0.f;
      kt_s[i * KP + kk] = in ? to_float(kb[pos * p.sk.s + ks + kk]) : 0.f;
      a_s[i * KP + kk] = in ? clip_w(wb[pos * p.sw.s + (ks + kk) * p.sw.k]) : 0.f;
    }
    for (int idx = tid; idx < KS * VT; idx += kThreads) {
      const int kk = idx / VT, j = idx % VT;
      g_s[kk * VT + j] = gc[(size_t)(ks + kk) * V + j];
    }
    __syncthreads();
    if (tid < KS) {
      float a = 0.f;
      for (int i = 0; i < rows; ++i) {
        a += a_s[i * KP + tid];
        qt_s[i * KP + tid] *= expf(a);
        kt_s[i * KP + tid] *= expf(fminf(-a, kGuard));
      }
      ea_s[tid] = expf(a);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      float x[kRows], y[kRows], ke[kRows], g[NV];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = ty + kTile * m, j = tx + kTile * m;
        x[m] = i < C ? qt_s[i * KP + kk] : 0.f;
        ke[m] = i < C ? kt_s[i * KP + kk] * ea_s[kk] : 0.f;
        y[m] = j < C ? kt_s[j * KP + kk] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < NV; ++n) g[n] = g_s[kk * VT + tx + kTile * n];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
#pragma unroll
        for (int n = 0; n < kRows; ++n) acc[m][n] += x[m] * y[n];
#pragma unroll
        for (int n = 0; n < NV; ++n) t[m][n] += ke[m] * g[n];
      }
    }
    __syncthreads();  // this slice of q~, k~ and dS is consumed
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const int i = ty + kTile * m, j = tx + kTile * n;
      if (i < C && j < C) p_s[i * CP + j] = j <= i ? acc[m][n] : 0.f;
    }
  for (int idx = tid; idx < C * VT; idx += kThreads) {
    const int i = idx / VT, j = idx % VT;
    do_s[i * VT + j] = i < rows ? to_float(db[(c0 + i) * p.sd.s + j]) : 0.f;
  }
  __syncthreads();
  for (int i = 0; i < C; ++i) {
    float pc[kRows], d[NV];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int j = ty + kTile * m;
      pc[m] = j < C ? p_s[i * CP + j] : 0.f;  // P[i][j]
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) d[n] = do_s[i * VT + tx + kTile * n];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int n = 0; n < NV; ++n) t[m][n] += pc[m] * d[n];
  }
  T* dvb = static_cast<T*>(p.dv) + ((size_t)bh * S + c0) * V + v0;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int j = ty + kTile * m;
    if (j >= rows) continue;
#pragma unroll
    for (int n = 0; n < NV; ++n)
      dvb[(size_t)j * V + tx + kTile * n] = from_float<T>(t[m][n]);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, size_t bytes, const BwdArgs& p,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int KT, int VT>
cudaError_t launch_tiles(const BwdArgs& p, int BH, cudaStream_t s) {
  constexpr int KS = KT < 32 ? KT : 32;
  const dim3 scan_grid(BH, p.V / VT, p.K / KT);
  const size_t scan_bytes = scan_smem(KT, VT, p.C);
  cudaError_t err = run(gla_bwd_scan_kernel<T, KT, VT, false>, scan_grid, scan_bytes, p, s);
  if (err == cudaSuccess)
    err = run(gla_bwd_scan_kernel<T, KT, VT, true>, scan_grid, scan_bytes, p, s);
  if (err == cudaSuccess)
    err = run(gla_bwd_dqk_kernel<T, KT>, dim3(BH, p.n, p.K / KT), dqk_smem(KT, p.C), p, s);
  if (err == cudaSuccess)
    err = run(gla_bwd_dv_kernel<T, VT, KS>, dim3(BH, p.n, p.V / VT),
              dv_smem(VT, KS, p.C), p, s);
  return err;
}

template <typename T, int KT>
cudaError_t launch_v(const BwdArgs& p, int BH, cudaStream_t s) {
  switch (p.V) {
    case 16:
      return launch_tiles<T, KT, 16>(p, BH, s);
    case 32:
      return launch_tiles<T, KT, 32>(p, BH, s);
    case 64:
    case 128:
      return launch_tiles<T, KT, 64>(p, BH, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_k(const BwdArgs& p, int BH, cudaStream_t s) {
  switch (p.K) {
    case 16:
      return launch_v<T, 16>(p, BH, s);
    case 32:
      return launch_v<T, 32>(p, BH, s);
    case 64:
    case 128:
      return launch_v<T, 64>(p, BH, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K and V each in {16, 32, 64, 128}; 1 <= C <= 128 (C = min(chunk, S)).
// Strides are in elements, in (B, H, S, last) order for q, k, v, w and dO.
// d_final may be null (a zero gradient of the final state).  states and
// dstates are fp32 workspaces of (B, H, ceil(S / C), K, V) elements each.
// is_bf16: 1 for bfloat16 q/k/v/dO/dq/dk/dv, 0 for float32; w and dw are
// float32 either way.  Launches four kernels on `stream` and returns the
// first cudaError_t that is not cudaSuccess, or cudaSuccess.
extern "C" int gla_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* w, const void* dout,
    const void* d_final, void* dq, void* dk, void* dv, void* dw, void* states,
    void* dstates, int B, int H, int S, int K, int V, int C, long long q_b,
    long long q_h, long long q_s, long long q_k, long long k_b, long long k_h,
    long long k_s, long long k_k, long long v_b, long long v_h, long long v_s,
    long long v_k, long long w_b, long long w_h, long long w_s, long long w_k,
    long long d_b, long long d_h, long long d_s, long long d_k, int is_bf16,
    void* stream) {
  if (C < 1 || C > kMaxC || S < 1 || q_k != 1 || k_k != 1 || v_k != 1 || d_k != 1
      || (w_k != 0 && w_k != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p{q, k, v, dout, static_cast<const float*>(w),
            static_cast<const float*>(d_final), dq, dk, dv, static_cast<float*>(dw),
            static_cast<float*>(states), static_cast<float*>(dstates),
            H, S, K, V, C, (S + C - 1) / C,
            {q_b, q_h, q_s, q_k}, {k_b, k_h, k_s, k_k}, {v_b, v_h, v_s, v_k},
            {w_b, w_h, w_s, w_k}, {d_b, d_h, d_s, d_k}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_k<__nv_bfloat16>(p, B * H, s)
                                  : launch_k<float>(p, B * H, s);
  return static_cast<int>(err);
}
