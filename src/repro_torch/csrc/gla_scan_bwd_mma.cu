// Backward of the chunked gated linear attention (GLA) scan on Hopper's
// tensor cores (sm_90a, warp-level mma.sync), for bf16 q/k/v/dO with
// K = V = 64.
//
// The JAX package has no Pallas backward: jax.grad differentiates through
// gla_scan_xla, whose forward gla_scan_pallas / _gla_kernel replaces
// (src/repro/kernels/ssm_scan/kernel.py:76, pallas_call at :90).  This
// computes that gradient, what gla_scan_bwd_ref (kernels/ssm_scan/ref.py)
// and the CUDA-core kernel in gla_scan_bwd.cu compute, on the calls the
// models make (RWKV6 and Mamba2 heads of 64, chunk 128); every other call
// takes gla_scan_bwd.cu, by the rule in kernels/ssm_scan/kernel.py::
// bwd_route.  From a zero initial state, given dO and the final state's
// gradient dS_n (or zero), per chunk c of C positions, with w <- clip(w,
// -30, 0), a = cumsum(w) within the chunk, q~ = q e^a, k~ = k e^min(-a, 60),
// e = e^{a_last}, S_c the state at the chunk's start, dS the gradient of the
// state after it, and G = e dS (row k of dS times e_k):
//   dP  = mask(dO v^T);   P = mask(q~ k~^T)
//   dq~ = dP k~ + dO S_c^T;           dq = dq~ e^a
//   dk~ = dP^T q~ + v G^T;            dk = dk~ e^min(-a, 60)
//   dv  = P^T dO + k~ G
//   da  = dq~ q~ - dk~ k~ [guard], plus sum_v dS S_{c+1} on the last row
//   dw  = reverse cumsum of da within the chunk, times [clip]
//   S_{c+1} = e (S_c + k~^T v);   dS_c = q~^T dO + e dS_{c+1}
// The last row's term is the reference's e (sum_v S_c dS + sum_i k~ (v
// dS^T)) = sum_v dS e (S_c + k~^T v), read from the states.  [guard] and
// [clip] are the derivatives of min(-a, 60) and of the clip, one half at a
// tie (-a == 60, w == 0, w == -30), as jax.grad gives them.
//
// Precision.  Every product runs on the tensor cores as mma.sync m16n8k16
// with bf16 operands and fp32 accumulation, as in gla_scan_mma.cu.  q, k,
// v and dO are bf16 already and exact.  Every operand formed in fp32 (q~,
// k~, P, dP, S_c and G) is split into hi = bf16(x) and lo = bf16(x - hi);
// a product of two such operands takes three MMAs (hi hi + hi lo + lo hi),
// a product with a bf16 input two, dO v^T one.  The causal mask is a
// select, never a multiply by 0: the masked triangle holds factors up to
// e^60.  With every split kept, dw (fp32) stays within 1e-4 of the largest
// |dw| of jax.vjp; dropping any one lo part but P's costs it about 2e-3.
// The torch emulation mma_bwd_emulation in tests/test_torch_gla_bwd.py
// shows both: it repeats these roundings product by product, and its
// docstring names the lines of this file that each of its lines follows.
//
// Layout.  Two launches on one stream:
//   1. gla_bwd_mma_states_kernel, grid (B * H, 2): a block of four warps
//      walks one (batch, head)'s chunks in order, forward (blockIdx.y 0,
//      writing S_c for c = 0..n to `states`, the last the final state) or
//      backward (1, writing dS_{c+1} for c = n-1..0 to `dstates`).  The
//      state (64 x 64 fp32) stays in registers, warp i owning its rows
//      16i..16i+15; each chunk's update is one 64 x C by C x 64 product,
//      k~^T v or q~^T dO with the fp32 factor split hi/lo (two MMAs).
//   2. gla_bwd_mma_kernel, grid (B * H, n chunks): one block of eight warps
//      per chunk forms P and dP and writes dq, dk, dv and dw; warp i owns
//      the chunk's 16-row tile i.  As keys it forms P^T and dP^T against
//      every query tile at or below the diagonal and accumulates dk~ and
//      dv; then as queries it forms dP against every key tile at or above
//      it and accumulates dq~ (dP is formed in both orientations, one exact
//      MMA per 16 x 8 tile, so that no sum crosses warps).  The decay runs
//      in the MMA accumulator layout: each lane scans its two rows of the
//      tile over the tile's 16 rows with shuffles, the tiles' sums combine
//      through shared memory, and a is kept there for the epilogues; the
//      first kernel uses the same scan, so both see the same bits of e.
//      da's reverse cumsum runs the same way in registers, and the later
//      tiles' sums come through shared memory.
// Nothing is atomic and every sum has a fixed order, so two calls give the
// same bits.  Rows at or past S arrive as zeros (the plain version's
// padding, with w = 0 there, so e is the last real row's) and are not
// written.  Exponentials run on the special-function unit (fast_exp).
//
// Shared memory and registers.  Kernel 2 keeps six C x 64 bf16 tiles (q~
// hi and lo, k~ hi and lo, v, dO), G and S_c as 64 x 64 hi/lo pairs and a
// in fp32: 170,496 bytes at C = 128, one block of eight warps an SM.  A
// layout of four warps with two tiles each fit two blocks an SM, but had
// no room for a: it re-read w and rescanned the decay in every epilogue,
// and the two blocks' long straight-line code missed the instruction
// cache, so it ran slower on an H100.  Rows of the bf16 tiles are 128
// bytes whose 16-byte chunks are XOR-swizzled by the row, so ldmatrix
// reads and the decay's stores fall in distinct banks without padding;
// a's rows are padded to 72 floats.  chip_smoke.py prints ptxas's
// registers and spills.  Kernel 1 takes 51,456 bytes at C = 128.
//
// Bound.  At RWKV6's training shape (B 8, H 64, S 2048, bf16) the bytes it
// must move (q, k, v, dO and w read, dq, dk, dv and dw written: 1.48 GB)
// bind an H100 at 0.44 ms, above the chunked form's 86 GFLOP at the bf16
// tensor-core rate (0.09 ms).  The design adds the two fp32 workspaces
// (143 MB and 134 MB there, written once and read about twice) and reads
// q, k, v, dO and w in both kernels: about 0.9 ms of bytes at the card's
// rate.  The hi/lo splits triple the products, to about 190 GFLOP of
// mma.sync work.
//
// Strides.  q, k, v and dO arrive as (B, H, S, 64) views with a contiguous
// last axis, 16-byte aligned, with B, H and S strides that are multiples of
// 8 elements (cp.async copies 16 bytes); w (fp32) with any strides and a
// K stride of 0 (Mamba2: one decay per head, read once per element) or 1.
// dS_n, dq, dk, dv, dw and the workspaces are contiguous.

#include <cstdint>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma;
using repro::split2;
using repro::store_u32;

constexpr int kDim = 64;                 // K = V = 64, the only width taken
constexpr int kStateThreads = 128;       // kernel 1: four warps
constexpr int kGradThreads = 256;        // kernel 2: eight warps, one 16-row tile each
constexpr int kMaxChunk = 128;
constexpr int kMaxTiles = kMaxChunk / 16;
constexpr int kState = kDim * kDim;
constexpr float kClamp = 30.f;           // w is clipped to [-kClamp, 0]
constexpr float kGuard = 60.f;           // exp(-a) saturates at e^kGuard
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* w;
  const float* d_final;  // (B, H, 64, 64) or null (zero)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dw;
  float* states;   // (B, H, n + 1, 64, 64): S_c, the last the final state
  float* dstates;  // (B, H, n, 64, 64): dS_{c+1}
  int H, S, C, n;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s;
  long long w_b, w_h, w_s, w_k;
};

// Element offset of (row r, column col) in a tile of 64 bf16 columns: rows
// of 128 bytes, 16-byte chunk j stored at chunk j ^ (r & 7).
__device__ __forceinline__ int swz(int r, int col) {
  return r * kDim + ((((col >> 3) ^ r) & 7) << 3) + (col & 7);
}

// e^x on the special-function unit: ex2 of x log2(e), whose rounding costs
// about 2^-18 of relative error at |x| = 60 (the guard), the splits' level.
__device__ __forceinline__ float fast_exp(float x) { return __expf(x); }

__device__ __forceinline__ float clip_w(float w) { return fminf(fmaxf(w, -kClamp), 0.f); }

// d clip(w, -30, 0) / dw, one half at either bound.
__device__ __forceinline__ float clip_grad(float w) {
  return (w > -kClamp && w < 0.f) ? 1.f : (w == -kClamp || w == 0.f) ? 0.5f : 0.f;
}

// d min(-a, 60) / d(-a), one half at the tie.
__device__ __forceinline__ float guard_grad(float neg_a) {
  return neg_a < kGuard ? 1.f : neg_a == kGuard ? 0.5f : 0.f;
}

// A 16 x 64 tile in the m16n8 accumulator layout: lane (g, cq) holds rows
// g (x[n][0..1]) and g + 8 (x[n][2..3]) at columns 8n + 2cq + {0, 1}.
using Tile = float[8][4];

// Raw w of the tile's rows row0 + {g, g + 8}; 0 past S.  The loads are
// unconditional (row 0 stands in), so that all are in flight together.
__device__ __forceinline__ void load_w(Tile& x, const float* wb, const Args& p,
                                       long long row0, int lane) {
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long r = row0 + g + 8 * hr;
    const bool ok = r < p.S;
    const float* wr = wb + (ok ? r : 0) * p.w_s;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * cq;
      const float x0 = wr[col * p.w_k], x1 = wr[(col + 1) * p.w_k];
      x[n][2 * hr] = ok ? x0 : 0.f;
      x[n][2 * hr + 1] = ok ? x1 : 0.f;
    }
  }
}

// In place: the inclusive sum over the tile's rows of each column.
__device__ __forceinline__ void scan_rows(Tile& x, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = __shfl_up_sync(kFull, x[n][e], 4 * d);
        if (g >= d) x[n][e] += y;
      }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) x[n][e + 2] += __shfl_sync(kFull, x[n][e], 28 + (lane & 3));
}

// In place: the reverse inclusive sum (row r gets rows r..15).
__device__ __forceinline__ void rscan_rows(Tile& x, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = __shfl_down_sync(kFull, x[n][e], 4 * d);
        if (g + d < 8) x[n][e] += y;
      }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) x[n][e] += __shfl_sync(kFull, x[n][e + 2], lane & 3);
}

// In place: clip(w) of a tile scanned over its rows, a less the tile's start.
__device__ __forceinline__ void decay_of(Tile& x, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = clip_w(x[n][e]);
  scan_rows(x, lane);
}

// Lanes with g == 7 hold the tile's sums (row 15): into t_s[64].
__device__ __forceinline__ void store_tile_sum(const Tile& x, float* t_s, int lane) {
  if ((lane >> 2) == 7) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      t_s[8 * n + 2 * (lane & 3)] = x[n][2];
      t_s[8 * n + 2 * (lane & 3) + 1] = x[n][3];
    }
  }
}

// a at the start of tile t for columns 8g + 2cq + {0, 1} (lane (g, cq)
// keeps these; add_start fetches them by shuffle): the sums of tiles
// 0..t-1 in order.
__device__ __forceinline__ void tile_start(float (&as)[2], const float* t_s, int t, int lane) {
  const int col = 8 * (lane >> 2) + 2 * (lane & 3);
  as[0] = as[1] = 0.f;
  for (int u = 0; u < t; ++u) {
    as[0] += t_s[u * kDim + col];
    as[1] += t_s[u * kDim + col + 1];
  }
}

__device__ __forceinline__ void add_start(Tile& x, const float (&as)[2], int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = __shfl_sync(kFull, as[e], 4 * n + (lane & 3));
      x[n][e] = s + x[n][e];
      x[n][e + 2] = s + x[n][e + 2];
    }
}

// e^{a_last} of the 64 columns from the nt tile sums, by warp 0.
__device__ __forceinline__ void chunk_decay(float* e_s, const float* t_s, int nt, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = 2 * lane + e;
    float a = 0.f;
    for (int u = 0; u < nt; ++u) a += t_s[u * kDim + col];
    e_s[col] = fast_exp(a);
  }
}

// The fp32 x of tile t's rows (from a tile of x in shared memory) scaled by
// f(a) and written back as hi over x and lo into `lo`.
template <bool kKeys>
__device__ __forceinline__ void scale_split(bf16* hi, bf16* lo, const Tile& a, int t, int lane) {
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int at = swz(16 * t + g + 8 * hr, 8 * n + 2 * cq);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi + at));
      const float a0 = a[n][2 * hr], a1 = a[n][2 * hr + 1];
      const float f0 = kKeys ? fast_exp(fminf(-a0, kGuard)) : fast_exp(a0);
      const float f1 = kKeys ? fast_exp(fminf(-a1, kGuard)) : fast_exp(a1);
      uint32_t h, l;
      split2(x.x * f0, x.y * f1, h, l);
      store_u32(hi + at, h);
      store_u32(lo + at, l);
    }
}

// hi + lo at (r, col) and (r, col + 1).
__device__ __forceinline__ float2 unsplit(const bf16* hi, const bf16* lo, int at) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi + at));
  const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lo + at));
  return make_float2(h.x + l.x, h.y + l.y);
}

// Copies of C rows of a (B, H, S, 64) bf16 view into a swizzled tile; rows
// at or past S are zero-filled.
template <int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long s_stride,
                                          long long c0, int C, int S, int tid) {
  for (int i = tid; i < C * 8; i += kThreads) {
    const int r = i >> 3, col = (i & 7) * 8;
    const long long pos = c0 + r;
    const bool ok = pos < S;
    cp_async16(dst + swz(r, col), src + (ok ? pos : 0) * s_stride + col, ok);
  }
}

// A 64 x 64 fp32 matrix (row k scaled by scale[k] when scale is not null)
// as swizzled hi/lo tiles.
template <int kThreads>
__device__ __forceinline__ void split_state(bf16* hi, bf16* lo, const float* src,
                                            const float* scale, int tid) {
  for (int i = tid; i < kState / 4; i += kThreads) {
    const int r = i >> 4, col = (i & 15) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * kDim + col);
    const float s = scale ? scale[r] : 1.f;
    uint32_t h, l;
    split2(x.x * s, x.y * s, h, l);
    store_u32(hi + swz(r, col), h);
    store_u32(lo + swz(r, col), l);
    split2(x.z * s, x.w * s, h, l);
    store_u32(hi + swz(r, col + 2), h);
    store_u32(lo + swz(r, col + 2), l);
  }
}

// ---------------------------------------------------------------------------
// Kernel 1: the two state recurrences.
// ---------------------------------------------------------------------------

inline size_t states_smem_bytes(int C) {
  return sizeof(bf16) * (size_t)3 * C * kDim + sizeof(float) * (kMaxTiles + 1) * kDim;
}

__global__ void __launch_bounds__(kStateThreads) gla_bwd_mma_states_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = p.C, S = p.S, nt = C / 16, tile = C * kDim;
  const bool rev = blockIdx.y == 1;
  bf16* xh = reinterpret_cast<bf16*>(smem_raw);  // k (q), then k~ (q~) hi
  bf16* xl = xh + tile;
  bf16* ys = xl + tile;                           // v (dO)
  float* t_s = reinterpret_cast<float*>(ys + tile);  // [kMaxTiles][64]: tile sums of w
  float* e_s = t_s + kMaxTiles * kDim;               // [64]: e^{a_last}

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3, lr = lane & 7, lm = lane >> 3;
  const bf16* xb = rev ? p.q + b * p.q_b + h * p.q_h : p.k + b * p.k_b + h * p.k_h;
  const bf16* yb = rev ? p.dout + b * p.d_b + h * p.d_h : p.v + b * p.v_b + h * p.v_h;
  const long long xs = rev ? p.q_s : p.k_s, ys_ = rev ? p.d_s : p.v_s;
  const float* wb = p.w + b * p.w_b + h * p.w_h;
  float* out = rev ? p.dstates + (size_t)bh * p.n * kState
                   : p.states + (size_t)bh * (p.n + 1) * kState;
  // This warp's 16-row tiles, clamped into the chunk; a clamped tile is
  // computed (every lane of the warp meets every shuffle) but not stored.
  const int own0 = min(warp, nt - 1), own1 = min(kMaxTiles - 1 - warp, nt - 1);
  const bool live0 = warp < nt, live1 = kMaxTiles - 1 - warp < nt;

  float st[8][4];  // rows 16 warp + {g, g + 8}, columns 8n + 2cq + {0, 1}
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = 16 * warp + g + 8 * (x >> 1), col = 8 * n + 2 * cq + (x & 1);
      st[n][x] = (rev && p.d_final) ? p.d_final[(size_t)bh * kState + row * kDim + col] : 0.f;
    }
  auto store_state = [&](int c) {
    float* o = out + (size_t)c * kState;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int row = 16 * warp + g, col = 8 * n + 2 * cq;
      *reinterpret_cast<float2*>(o + row * kDim + col) = make_float2(st[n][0], st[n][1]);
      *reinterpret_cast<float2*>(o + (row + 8) * kDim + col) = make_float2(st[n][2], st[n][3]);
    }
  };

  for (int step = 0; step < p.n; ++step) {
    const int c = rev ? p.n - 1 - step : step;
    const long long c0 = (long long)c * C;
    store_state(c);
    if (rev && step == p.n - 1) break;  // dS_0 is not needed
    load_rows<kStateThreads>(xh, xb, xs, c0, C, S, tid);
    load_rows<kStateThreads>(ys, yb, ys_, c0, C, S, tid);
    cp_async_commit();
    Tile wa[2];
    load_w(wa[0], wb, p, c0 + 16 * own0, lane);
    load_w(wa[1], wb, p, c0 + 16 * own1, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      decay_of(wa[u], lane);
      if (u ? live1 : live0) store_tile_sum(wa[u], t_s + (u ? own1 : own0) * kDim, lane);
    }
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles and the tile sums are in
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float as[2];
      tile_start(as, t_s, u ? own1 : own0, lane);
      add_start(wa[u], as, lane);
      if (u ? live1 : live0) {
        if (rev)
          scale_split<false>(xh, xl, wa[u], u ? own1 : own0, lane);
        else
          scale_split<true>(xh, xl, wa[u], u ? own1 : own0, lane);
      }
    }
    if (warp == 0) chunk_decay(e_s, t_s, nt, lane);
    __syncthreads();  // k~ (q~) and e are in
    const float e0 = e_s[16 * warp + g], e1 = e_s[16 * warp + g + 8];
    if (rev) {  // dS <- e dS + q~^T dO
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        st[n][0] *= e0;
        st[n][1] *= e0;
        st[n][2] *= e1;
        st[n][3] *= e1;
      }
    }
    // x~^T y on this warp's 16 rows: A = x~^T (x~ stored [position][K],
    // read transposed), B = y ([position][V], read transposed).
#pragma unroll 2
    for (int rs = 0; rs < nt; ++rs) {
      const int at = swz(16 * rs + (lm >> 1) * 8 + lr, 16 * warp + (lm & 1) * 8);
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, xh + at);
      ldsm_x4_t(al, xl + at);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t by[4];
        ldsm_x4_t(by, ys + swz(16 * rs + (lm & 1) * 8 + lr, 16 * np + (lm >> 1) * 8));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma(st[2 * np + e], ah, by[2 * e], by[2 * e + 1]);
          mma(st[2 * np + e], al, by[2 * e], by[2 * e + 1]);
        }
      }
    }
    if (!rev) {  // S <- e (S + k~^T v)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        st[n][0] *= e0;
        st[n][1] *= e0;
        st[n][2] *= e1;
        st[n][3] *= e1;
      }
    }
    __syncthreads();  // this chunk's tiles, tile sums and e are consumed
  }
  if (!rev) store_state(p.n);
}

// ---------------------------------------------------------------------------
// Kernel 2: dq, dk, dv and dw of one chunk.
// ---------------------------------------------------------------------------

constexpr int kALd = kDim + 8;  // padded fp32 row of a: float2 reads by lanes (g, cq) miss no bank

inline size_t grad_smem_bytes(int C) {
  return sizeof(bf16) * ((size_t)6 * C * kDim + 4 * kState)
         + sizeof(float) * ((size_t)C * kALd + (kMaxTiles + 2) * kDim);
}

struct Smem {
  bf16 *qh, *ql, *kh, *kl, *vs, *ds;  // [C][64] each, swizzled
  bf16 *gh, *gl, *sh, *sl;            // [64][64]: G and S_c, hi and lo
  float* a_s;                         // [C][kALd]: a
  float* t_s;                         // [kMaxTiles][64]: tile sums of w, then of da
  float* e_s;                         // [64]: e^{a_last}
  float* x_s;                         // [64]: sum_v dS_{c+1} S_{c+1}
};

// a of tile t's rows in the accumulator layout, from shared memory.
__device__ __forceinline__ void read_a(Tile& a, const float* a_s, int t, int lane) {
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 x =
          *reinterpret_cast<const float2*>(a_s + (16 * t + g + 8 * hr) * kALd + 8 * n + 2 * cq);
      a[n][2 * hr] = x.x;
      a[n][2 * hr + 1] = x.y;
    }
}

// The key side of tile j: dk~ = dP^T q~ + v G^T and dv = P^T dO + k~ G over
// query tiles i >= j; writes dk and dv and leaves -dk~ k~ [guard] in `da`.
__device__ __forceinline__ void key_side(const Smem& m, const Args& p, Tile& da, int j,
                                         bool live, int nt, long long c0, size_t out0,
                                         int lane) {
  const int g = lane >> 2, cq = lane & 3, lr = lane & 7, lm = lane >> 3;
  float dkt[8][4], dvt[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dkt[n][x] = dvt[n][x] = 0.f;
  // A fragments of k~_j (hi, lo) and v_j, one per 16 columns.
  uint32_t ka[4][4], kal[4][4], va[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int at = swz(16 * j + (lm & 1) * 8 + lr, 16 * ks + (lm >> 1) * 8);
    ldsm_x4(ka[ks], m.kh + at);
    ldsm_x4(kal[ks], m.kl + at);
    ldsm_x4(va[ks], m.vs + at);
  }
  // v G^T (G stored [K][V]: B read as is) and k~ G (B read transposed).
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t gh[4], gl[4];
      const int at = swz(16 * np + (lm >> 1) * 8 + lr, 16 * ks + (lm & 1) * 8);
      ldsm_x4(gh, m.gh + at);
      ldsm_x4(gl, m.gl + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(dkt[2 * np + e], va[ks], gh[2 * e], gh[2 * e + 1]);
        mma(dkt[2 * np + e], va[ks], gl[2 * e], gl[2 * e + 1]);
      }
      const int at_t = swz(16 * ks + (lm & 1) * 8 + lr, 16 * np + (lm >> 1) * 8);
      ldsm_x4_t(gh, m.gh + at_t);
      ldsm_x4_t(gl, m.gl + at_t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(dvt[2 * np + e], ka[ks], gh[2 * e], gh[2 * e + 1]);
        mma(dvt[2 * np + e], ka[ks], gl[2 * e], gl[2 * e + 1]);
        mma(dvt[2 * np + e], kal[ks], gh[2 * e], gh[2 * e + 1]);
      }
    }
  }
#pragma unroll 1
  for (int i = j; i < nt; ++i) {
    // P^T = k~_j q~_i^T and dP^T = v_j dO_i^T: keys as rows, queries as
    // columns (q~ and dO stored [query][*]: B read as is).
    float pt[2][4], dpt[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) pt[e][x] = dpt[e][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int at = swz(16 * i + (lm >> 1) * 8 + lr, 16 * ks + (lm & 1) * 8);
      uint32_t qb[4], qbl[4], db[4];
      ldsm_x4(qb, m.qh + at);
      ldsm_x4(qbl, m.ql + at);
      ldsm_x4(db, m.ds + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(pt[e], ka[ks], qb[2 * e], qb[2 * e + 1]);
        mma(pt[e], ka[ks], qbl[2 * e], qbl[2 * e + 1]);
        mma(pt[e], kal[ks], qb[2 * e], qb[2 * e + 1]);
        mma(dpt[e], va[ks], db[2 * e], db[2 * e + 1]);
      }
    }
    if (i == j) {  // keep query >= key: a select, never a multiply
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool drop = 8 * e + 2 * cq + (x & 1) < g + 8 * (x >> 1);
          pt[e][x] = drop ? 0.f : pt[e][x];
          dpt[e][x] = drop ? 0.f : dpt[e][x];
        }
    }
    // The accumulator layout of two n-tiles is the m16k16 A layout.
    uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split2(pt[e][0], pt[e][1], ph[2 * e], pl[2 * e]);
      split2(pt[e][2], pt[e][3], ph[2 * e + 1], pl[2 * e + 1]);
      split2(dpt[e][0], dpt[e][1], dh[2 * e], dl[2 * e]);
      split2(dpt[e][2], dpt[e][3], dh[2 * e + 1], dl[2 * e + 1]);
    }
    // dv += P^T dO_i, dk~ += dP^T q~_i (dO and q~ stored [query][*]: B
    // read transposed).
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int at = swz(16 * i + (lm & 1) * 8 + lr, 16 * np + (lm >> 1) * 8);
      uint32_t bd[4], bq[4], bql[4];
      ldsm_x4_t(bd, m.ds + at);
      ldsm_x4_t(bq, m.qh + at);
      ldsm_x4_t(bql, m.ql + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(dvt[2 * np + e], ph, bd[2 * e], bd[2 * e + 1]);
        mma(dvt[2 * np + e], pl, bd[2 * e], bd[2 * e + 1]);
        mma(dkt[2 * np + e], dh, bq[2 * e], bq[2 * e + 1]);
        mma(dkt[2 * np + e], dh, bql[2 * e], bql[2 * e + 1]);
        mma(dkt[2 * np + e], dl, bq[2 * e], bq[2 * e + 1]);
      }
    }
  }
  // dk = dk~ e^min(-a, 60), dv, and -dk~ k~ [guard] of the tile's rows.
  Tile a;
  read_a(a, m.a_s, j, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * j + g + 8 * hr, col = 8 * n + 2 * cq;
      const float2 kt = unsplit(m.kh, m.kl, swz(r, col));
      const float a0 = a[n][2 * hr], a1 = a[n][2 * hr + 1];
      const float d0 = dkt[n][2 * hr], d1 = dkt[n][2 * hr + 1];
      da[n][2 * hr] = -(d0 * kt.x * guard_grad(-a0));
      da[n][2 * hr + 1] = -(d1 * kt.y * guard_grad(-a1));
      if (live && c0 + r < p.S) {
        const size_t at = out0 + (size_t)r * kDim + col;
        *reinterpret_cast<__nv_bfloat162*>(p.dk + at) = __floats2bfloat162_rn(
            d0 * fast_exp(fminf(-a0, kGuard)), d1 * fast_exp(fminf(-a1, kGuard)));
        *reinterpret_cast<__nv_bfloat162*>(p.dv + at) =
            __floats2bfloat162_rn(dvt[n][2 * hr], dvt[n][2 * hr + 1]);
      }
    }
}

// The query side of tile i: dq~ = dP k~ + dO S_c^T over key tiles j <= i;
// writes dq, adds dq~ q~ to `da` and takes its reverse cumsum over the
// tile's rows.
__device__ __forceinline__ void query_side(const Smem& m, const Args& p, Tile& da, int i,
                                           bool live, long long c0, size_t out0,
                                           int lane) {
  const int g = lane >> 2, cq = lane & 3, lr = lane & 7, lm = lane >> 3;
  float dqt[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dqt[n][x] = 0.f;
  uint32_t doa[4][4];  // A fragments of dO_i
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(doa[ks], m.ds + swz(16 * i + (lm & 1) * 8 + lr, 16 * ks + (lm >> 1) * 8));
  // dO S_c^T (S_c stored [K][V]: B read as is).
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int at = swz(16 * np + (lm >> 1) * 8 + lr, 16 * ks + (lm & 1) * 8);
      uint32_t sh[4], sl[4];
      ldsm_x4(sh, m.sh + at);
      ldsm_x4(sl, m.sl + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(dqt[2 * np + e], doa[ks], sh[2 * e], sh[2 * e + 1]);
        mma(dqt[2 * np + e], doa[ks], sl[2 * e], sl[2 * e + 1]);
      }
    }
#pragma unroll 1
  for (int j = 0; j <= i; ++j) {
    // dP = dO_i v_j^T: queries as rows (v stored [key][V]: B read as is).
    float dp[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) dp[e][0] = dp[e][1] = dp[e][2] = dp[e][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t vb[4];
      ldsm_x4(vb, m.vs + swz(16 * j + (lm >> 1) * 8 + lr, 16 * ks + (lm & 1) * 8));
#pragma unroll
      for (int e = 0; e < 2; ++e) mma(dp[e], doa[ks], vb[2 * e], vb[2 * e + 1]);
    }
    if (j == i) {  // keep key <= query: a select, never a multiply
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dp[e][x] = 8 * e + 2 * cq + (x & 1) > g + 8 * (x >> 1) ? 0.f : dp[e][x];
    }
    uint32_t dh[4], dl[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split2(dp[e][0], dp[e][1], dh[2 * e], dl[2 * e]);
      split2(dp[e][2], dp[e][3], dh[2 * e + 1], dl[2 * e + 1]);
    }
    // dq~ += dP k~_j (k~ stored [key][K]: B read transposed).
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int at = swz(16 * j + (lm & 1) * 8 + lr, 16 * np + (lm >> 1) * 8);
      uint32_t bk[4], bkl[4];
      ldsm_x4_t(bk, m.kh + at);
      ldsm_x4_t(bkl, m.kl + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(dqt[2 * np + e], dh, bk[2 * e], bk[2 * e + 1]);
        mma(dqt[2 * np + e], dh, bkl[2 * e], bkl[2 * e + 1]);
        mma(dqt[2 * np + e], dl, bk[2 * e], bk[2 * e + 1]);
      }
    }
  }
  // dq = dq~ e^a; da = dq~ q~ - dk~ k~ [guard].
  Tile a;
  read_a(a, m.a_s, i, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * i + g + 8 * hr, col = 8 * n + 2 * cq;
      const float2 qt = unsplit(m.qh, m.ql, swz(r, col));
      const float d0 = dqt[n][2 * hr], d1 = dqt[n][2 * hr + 1];
      da[n][2 * hr] = da[n][2 * hr] + d0 * qt.x;
      da[n][2 * hr + 1] = da[n][2 * hr + 1] + d1 * qt.y;
      if (live && c0 + r < p.S)
        *reinterpret_cast<__nv_bfloat162*>(p.dq + out0 + (size_t)r * kDim + col) =
            __floats2bfloat162_rn(d0 * fast_exp(a[n][2 * hr]), d1 * fast_exp(a[n][2 * hr + 1]));
    }
  rscan_rows(da, lane);
}

// dw of tile t: [clip] (the tile's reverse cumsum of da + the later tiles'
// sums + the last row's term), from d_s[kMaxTiles][64] and x_s[64].
__device__ __forceinline__ void write_dw(const Args& p, const Tile& da, const float* d_s,
                                         const float* x_s, int t, int nt, long long c0,
                                         size_t out0, const float* wb, int lane) {
  const int g = lane >> 2, cq = lane & 3;
  Tile w;
  load_w(w, wb, p, c0 + 16 * t, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * cq;
    float later0 = x_s[col], later1 = x_s[col + 1];
    for (int u = nt - 1; u > t; --u) {
      later0 += d_s[u * kDim + col];
      later1 += d_s[u * kDim + col + 1];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * t + g + 8 * hr;
      if (c0 + r < p.S)
        *reinterpret_cast<float2*>(p.dw + out0 + (size_t)r * kDim + col) = make_float2(
            (da[n][2 * hr] + later0) * clip_grad(w[n][2 * hr]),
            (da[n][2 * hr + 1] + later1) * clip_grad(w[n][2 * hr + 1]));
    }
  }
}

__global__ void __launch_bounds__(kGradThreads, 1) gla_bwd_mma_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = p.C, S = p.S, nt = C / 16, tile = C * kDim;
  Smem m;
  m.qh = reinterpret_cast<bf16*>(smem_raw);  // q, then q~ hi
  m.ql = m.qh + tile;
  m.kh = m.ql + tile;                         // k, then k~ hi
  m.kl = m.kh + tile;
  m.vs = m.kl + tile;
  m.ds = m.vs + tile;                         // dO
  m.gh = m.ds + tile;
  m.gl = m.gh + kState;
  m.sh = m.gl + kState;
  m.sl = m.sh + kState;
  m.a_s = reinterpret_cast<float*>(m.sl + kState);
  m.t_s = m.a_s + C * kALd;
  m.e_s = m.t_s + kMaxTiles * kDim;
  m.x_s = m.e_s + kDim;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const long long c0 = (long long)c * C;
  const size_t out0 = ((size_t)bh * S + c0) * kDim;
  const float* wb = p.w + b * p.w_b + h * p.w_h;
  // This warp's 16-row tile, clamped into the chunk; a clamped tile is
  // computed (every lane of the warp meets every shuffle) but not stored.
  const int t = min(warp, nt - 1);
  const bool live = warp < nt;

  // 1. q, k, v and dO of the chunk; the decay of this warp's rows and its
  //    sums.
  load_rows<kGradThreads>(m.qh, p.q + b * p.q_b + h * p.q_h, p.q_s, c0, C, S, tid);
  load_rows<kGradThreads>(m.kh, p.k + b * p.k_b + h * p.k_h, p.k_s, c0, C, S, tid);
  load_rows<kGradThreads>(m.vs, p.v + b * p.v_b + h * p.v_h, p.v_s, c0, C, S, tid);
  load_rows<kGradThreads>(m.ds, p.dout + b * p.d_b + h * p.d_h, p.d_s, c0, C, S, tid);
  cp_async_commit();
  Tile a;
  load_w(a, wb, p, c0 + 16 * t, lane);
  decay_of(a, lane);
  if (live) store_tile_sum(a, m.t_s + t * kDim, lane);
  cp_async_wait_all();
  __syncthreads();  // the tiles and the tile sums are in

  // 2. a of this warp's rows into a_s; q~ and k~ as hi/lo tiles; e.
  {
    float as[2];
    tile_start(as, m.t_s, t, lane);
    add_start(a, as, lane);
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(m.a_s + (16 * t + g + 8 * hr) * kALd + 8 * n + 2 * cq) =
            make_float2(a[n][2 * hr], a[n][2 * hr + 1]);
    scale_split<false>(m.qh, m.ql, a, t, lane);
    scale_split<true>(m.kh, m.kl, a, t, lane);
  }
  if (warp == 0) chunk_decay(m.e_s, m.t_s, nt, lane);
  __syncthreads();  // a, q~, k~ and e are in; the tile sums are consumed

  // 3. G = e dS_{c+1} and S_c as hi/lo tiles.
  split_state<kGradThreads>(m.gh, m.gl, p.dstates + ((size_t)bh * p.n + c) * kState, m.e_s,
                            tid);
  split_state<kGradThreads>(m.sh, m.sl, p.states + ((size_t)bh * (p.n + 1) + c) * kState,
                            nullptr, tid);
  __syncthreads();

  // 4. The key side, then the query side, of this warp's tile.
  Tile da;
  key_side(m, p, da, t, live, nt, c0, out0, lane);
  query_side(m, p, da, t, live, c0, out0, lane);

  // 5. dw: each tile's sums of da (its reverse cumsum at row 0) and the last
  //    row's term sum_v dS_{c+1} S_{c+1} meet in shared memory.
  if (live && g == 0) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      m.t_s[t * kDim + 8 * n + 2 * cq] = da[n][0];
      m.t_s[t * kDim + 8 * n + 2 * cq + 1] = da[n][1];
    }
  }
  if (tid < 2 * kDim) {
    const int r = tid >> 1, half = tid & 1;
    const float4* sn = reinterpret_cast<const float4*>(
        p.states + ((size_t)bh * (p.n + 1) + c + 1) * kState + r * kDim + 32 * half);
    const float4* gn = reinterpret_cast<const float4*>(
        p.dstates + ((size_t)bh * p.n + c) * kState + r * kDim + 32 * half);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = sn[i], y = gn[i];
      s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    s += __shfl_xor_sync(kFull, s, 1);
    if (half == 0) m.x_s[r] = s;
  }
  __syncthreads();
  if (live) write_dw(p, da, m.t_s, m.x_s, t, nt, c0, out0, wb, lane);
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

cudaError_t launch(const Args& p, int BH, cudaStream_t stream) {
  const size_t sb = states_smem_bytes(p.C), gb = grad_smem_bytes(p.C);
  cudaError_t err = cudaFuncSetAttribute(gla_bwd_mma_states_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sb));
  if (err != cudaSuccess) return err;
  gla_bwd_mma_states_kernel<<<dim3(BH, 2), kStateThreads, sb, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gla_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gb));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gla_bwd_mma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  gla_bwd_mma_kernel<<<dim3(BH, p.n), kGradThreads, gb, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// bf16 q, k, v, dO (B, H, S, 64), fp32 w (B, H, S, 64); 16 <= C <= 128 with
// C % 16 == 0 (C = min(chunk, S)); strides in elements, (B, H, S) for q, k,
// v and dO, (B, H, S, K) for w.  d_final (B, H, 64, 64) fp32 may be null (a
// zero gradient of the final state).  Writes bf16 dq, dk, dv and fp32 dw,
// all (B, H, S, 64) and contiguous; states and dstates are fp32 workspaces
// of (B, H, ceil(S / C) + 1, 64, 64) and (B, H, ceil(S / C), 64, 64)
// elements.  Launches two kernels on `stream` and returns the first
// cudaError_t that is not cudaSuccess, or cudaSuccess.
extern "C" int gla_scan_bwd_mma_launch(
    const void* q, const void* k, const void* v, const void* w, const void* dout,
    const void* d_final, void* dq, void* dk, void* dv, void* dw, void* states,
    void* dstates, int B, int H, int S, int C, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long d_b, long long d_h, long long d_s,
    long long w_b, long long w_h, long long w_s, long long w_k, void* stream) {
  const long long strides[] = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s};
  bool ok = S >= 1 && C >= 16 && C <= kMaxChunk && C % 16 == 0 && (w_k == 0 || w_k == 1)
            && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)
            && aligned16(states) && aligned16(dstates);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
         static_cast<const float*>(w), static_cast<const float*>(d_final),
         static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
         static_cast<float*>(dw), static_cast<float*>(states), static_cast<float*>(dstates),
         H, S, C, (S + C - 1) / C,
         q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s,
         w_b, w_h, w_s, w_k};
  return static_cast<int>(launch(p, B * H, static_cast<cudaStream_t>(stream)));
}
