// Chunked gated linear attention (GLA) scan for Hopper (sm_90a).
//
// Replaces gla_scan_pallas / _gla_kernel (src/repro/kernels/ssm_scan/
// kernel.py) and computes what gla_scan_xla (ops.py) computes, from a zero
// state.  Per chunk of C positions, for each (batch, head):
//   w <- clamp(w, -30, 0);  a = cumsum(w) within the chunk
//   q~ = q * e^a;  k~ = k * e^min(-a, 60)
//   o  = causal(q~ k~^T) v + q~ S
//   S <- e^{a_last} S + (k~ e^{a_last})^T v
// The exponent guard is the reference's, copied on purpose: the factor that
// matters is e^{a_i - a_j}, so once a chunk's decay passes 60 the reference
// drops even local terms (ROADMAP.md, Queue 3); the port is held to it.
//
// Layout.  The Pallas kernel carries S in VMEM across a sequential
// ("arbitrary") chunk axis.  Here one block per (batch * head, V tile) walks
// its chunks in order and keeps S (K x VT fp32) in shared memory.  V is cut
// into tiles of at most 64 columns: the columns of S and o are independent,
// and only the scores q~ k~^T are formed again per tile.  Each chunk is
// handled a stripe of 16 rows at a time: the running decay, q~ and k~ of
// the stripe's rows are formed by one thread per key column, then the
// stripe's scores against every earlier row of the chunk, then its outputs.
// k~ and v of the whole chunk stay in shared memory for the state update at
// the chunk's end; q~ and the scores only for the stripe.  Shared memory is
// about 95 KB at K = V = 64, C = 128 (two blocks per SM) and 149 KB at
// K = 128 (one).  Positions at or past S are never loaded: the plain
// version's zero padding (k = v = 0, w = 0) adds nothing to o or S.
//
// Bound.  At the RWKV6 prefill shape (B 8, H 64, S 512, K = V = 64, bf16
// q/k/v, fp32 w) the bytes of q, k, v, w, o and the final state bind an H100
// well before the chunked form's 13 GFLOP do (chip_smoke.py computes both).
// This first version multiplies in fp32 on CUDA cores: the e^60 factor in k~
// amplifies TF32 or bf16 rounding, so tensor cores (wgmma) wait for a
// measured tolerance.  Its real limit is shared-memory traffic of those
// multiply-adds and the serial chunk walk of one block per (b, h).
//
// Strides.  q, k, v and w arrive as (B, H, S, *) views with any strides for
// B, H and S and a contiguous last axis, except that w's K axis may have
// stride 0 (Mamba2: one decay per head).  o (B, H, S, V) and the final state
// (B, H, K, V) are contiguous.

#include "common.cuh"

namespace {

using repro::to_float;

constexpr int kThreads = 256;
constexpr int kStripe = 16;     // rows of a chunk whose scores are formed together
constexpr float kClamp = 30.f;  // w is clamped to [-kClamp, 0]
constexpr float kGuard = 60.f;  // exp(-a) saturates at e^kGuard

struct Strides {
  long long b, h, s, k;
};

struct GlaArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* w;
  void* o;
  float* state;
  int H, S, V, C;
  Strides sq, sk, sv, sw;
};

// Shared-memory floats of one block; rows of K floats are padded to K + 1 so
// that threads reading one column of consecutive rows hit distinct banks.
inline size_t smem_floats(int K, int VT, int C) {
  return (size_t)C * (K + 1)          // k~ of the chunk
         + (size_t)C * VT             // v of the chunk, this V tile
         + (size_t)K * VT             // state S
         + (size_t)kStripe * (K + 1)  // q~ of the stripe
         + (size_t)kStripe * C        // scores of the stripe
         + K;                         // e^{a_last}
}

template <typename T, int K, int VT>
__global__ void __launch_bounds__(kThreads) gla_scan_kernel(GlaArgs p) {
  constexpr int KP = K + 1;
  constexpr int kGroups = kThreads / VT;             // threads per V column
  constexpr int kRowsPer = kStripe * VT / kThreads;  // stripe rows per thread
  constexpr int kKeysPer = K * VT / kThreads;        // state rows per thread
  static_assert(kRowsPer >= 1 && kKeysPer >= 1, "tile too small for the block");

  const int C = p.C, S = p.S;
  extern __shared__ float smem[];
  float* kt_s = smem;                 // [C][KP]
  float* v_s = kt_s + C * KP;         // [C][VT]
  float* st_s = v_s + C * VT;         // [K][VT]
  float* qt_s = st_s + K * VT;        // [kStripe][KP]
  float* sc_s = qt_s + kStripe * KP;  // [kStripe][C]
  float* ea_s = sc_s + kStripe * C;   // [K]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int v0 = blockIdx.y * VT;
  const int tid = threadIdx.x;
  const int vcol = tid % VT, grp = tid / VT;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h + v0;
  const float* wb = p.w + b * p.sw.b + h * p.sw.h;
  T* ob = static_cast<T*>(p.o) + (size_t)bh * S * p.V + v0;

  for (int i = tid; i < K * VT; i += kThreads) st_s[i] = 0.f;
  float a = 0.f;  // running log decay of key column tid (threads < K)

  for (int c0 = 0; c0 < S; c0 += C) {
    const int n = min(C, S - c0);  // rows of this chunk inside the sequence
    a = 0.f;
    for (int r0 = 0; r0 < n; r0 += kStripe) {
      const int rows = min(kStripe, n - r0);
      // 1. Running decay, q~ and k~ of the stripe (one thread per key
      //    column), and the stripe's v rows (all threads).
      if (tid < K) {
#pragma unroll
        for (int i = 0; i < kStripe; ++i) {
          if (i < rows) {
            const long long pos = c0 + r0 + i;
            a += fminf(fmaxf(wb[pos * p.sw.s + tid * p.sw.k], -kClamp), 0.f);
            qt_s[i * KP + tid] = to_float(qb[pos * p.sq.s + tid]) * expf(a);
            kt_s[(r0 + i) * KP + tid] =
                to_float(kb[pos * p.sk.s + tid]) * expf(fminf(-a, kGuard));
          }
        }
      }
      for (int idx = tid; idx < rows * VT; idx += kThreads) {
        const int i = idx / VT, j = idx % VT;
        v_s[(r0 + i) * VT + j] = to_float(vb[(c0 + r0 + i) * p.sv.s + j]);
      }
      __syncthreads();

      // 2. Scores of the stripe's rows against rows [0, r0 + rows) of the
      //    chunk, zero above the diagonal.
      const int width = r0 + rows;
      for (int idx = tid; idx < rows * width; idx += kThreads) {
        const int i = idx / width, j = idx % width;
        float s = 0.f;
        if (j <= r0 + i) {
#pragma unroll 16
          for (int kk = 0; kk < K; ++kk) s += qt_s[i * KP + kk] * kt_s[j * KP + kk];
        }
        sc_s[i * C + j] = s;
      }
      __syncthreads();

      // 3. Outputs: intra-chunk (scores x v) plus cross-chunk (q~ x S).
      float intra[kRowsPer], cross[kRowsPer];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) intra[r] = cross[r] = 0.f;
      for (int j = 0; j < width; ++j) {
        const float vv = v_s[j * VT + vcol];
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r)
          intra[r] += sc_s[(grp + r * kGroups) * C + j] * vv;
      }
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) {
        const float sv = st_s[kk * VT + vcol];
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r)
          cross[r] += qt_s[(grp + r * kGroups) * KP + kk] * sv;
      }
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const int i = grp + r * kGroups;
        if (i < rows)
          ob[(size_t)(c0 + r0 + i) * p.V + vcol] =
              repro::from_float<T>(intra[r] + cross[r]);
      }
      __syncthreads();  // q~ and the scores are consumed
    }

    // 4. State update at the chunk's end: S <- e^{a_last} S + (k~ e^{a_last})^T v.
    if (tid < K) ea_s[tid] = expf(a);
    __syncthreads();
    float acc[kKeysPer];
#pragma unroll
    for (int r = 0; r < kKeysPer; ++r) acc[r] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float vv = v_s[j * VT + vcol];
#pragma unroll
      for (int r = 0; r < kKeysPer; ++r) {
        const int kk = grp + r * kGroups;
        acc[r] += kt_s[j * KP + kk] * ea_s[kk] * vv;
      }
    }
#pragma unroll
    for (int r = 0; r < kKeysPer; ++r) {
      const int kk = grp + r * kGroups;
      st_s[kk * VT + vcol] = st_s[kk * VT + vcol] * ea_s[kk] + acc[r];
    }
    __syncthreads();  // k~, v and the state are consumed
  }

  for (int idx = tid; idx < K * VT; idx += kThreads) {
    const int kk = idx / VT, j = idx % VT;
    p.state[((size_t)bh * K + kk) * p.V + v0 + j] = st_s[idx];
  }
}

template <typename T, int K, int VT>
cudaError_t launch(const GlaArgs& p, int BH, cudaStream_t stream) {
  const size_t bytes = smem_floats(K, VT, p.C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<T, K, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, p.V / VT);
  gla_scan_kernel<T, K, VT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_v(const GlaArgs& p, int BH, cudaStream_t stream) {
  switch (p.V) {
    case 16:
      return launch<T, K, 16>(p, BH, stream);
    case 32:
      return launch<T, K, 32>(p, BH, stream);
    case 64:
    case 128:
      return launch<T, K, 64>(p, BH, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_k(int K, const GlaArgs& p, int BH, cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch_v<T, 16>(p, BH, stream);
    case 32:
      return launch_v<T, 32>(p, BH, stream);
    case 64:
      return launch_v<T, 64>(p, BH, stream);
    case 128:
      return launch_v<T, 128>(p, BH, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K and V each in {16, 32, 64, 128}; 1 <= C <= 128 (C = min(chunk, S)).
// Strides are in elements, in (B, H, S, last) order for q, k, v and w.
// is_bf16: 1 for bfloat16 q/k/v/o, 0 for float32; w is float32 either way.
// Returns a cudaError_t.
extern "C" int gla_scan_launch(const void* q, const void* k, const void* v,
                               const void* w, void* o, void* state, int B,
                               int H, int S, int K, int V, int C,
                               long long q_b, long long q_h, long long q_s,
                               long long q_k, long long k_b, long long k_h,
                               long long k_s, long long k_k, long long v_b,
                               long long v_h, long long v_s, long long v_k,
                               long long w_b, long long w_h, long long w_s,
                               long long w_k, int is_bf16, void* stream) {
  if (C < 1 || C > 128 || q_k != 1 || k_k != 1 || v_k != 1 || (w_k != 0 && w_k != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  GlaArgs p{q, k, v, static_cast<const float*>(w), o, static_cast<float*>(state),
            H, S, V, C, {q_b, q_h, q_s, q_k}, {k_b, k_h, k_s, k_k},
            {v_b, v_h, v_s, v_k}, {w_b, w_h, w_s, w_k}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_k<__nv_bfloat16>(K, p, B * H, s)
                                  : launch_k<float>(K, p, B * H, s);
  return static_cast<int>(err);
}
