// Backward GQA flash attention in bf16 on Hopper's tensor cores (sm_90a).
//
// The gradient of flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attention/kernel.py:96) for bf16 inputs at D 32,
// 64, 128 and 320; fp32 inputs take the CUDA-core backward in
// flash_attention_bwd.cu.  The JAX package has no Pallas backward: it
// differentiates its chunked jnp path.  Same semantics as the forward and
// as attention_bwd_ref (kernels/flash_attention/ref.py): scale D**-0.5 (or
// the caller's), causal masking at q_offset, an optional sliding window
// (keys with kpos > qpos - window), ragged Sq and Sk, any G = Hq / Hkv,
// P = 0 where a key is masked, so a row that sees no key gets zero
// gradients:
//
//   P  = exp(q k^T * scale - lse),  lse from the forward
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O)
//   dQ = dS K * scale,  dK = dS^T Q * scale  (dK, dV summed over G heads)
//
// Bound: at TinyLlama's training shape (B 8, S 2048, 32/4 heads of 64,
// causal) the backward does 2.5x the forward's 137.4 GFLOP (dV, dP, dQ, dK
// and one S: 0.347 ms at 989 TFLOP/s bf16) against 302 MB of q, k, v, o, do
// read and dq, dk, dv written (0.090 ms at 3.35 TB/s): operations bind it,
// so every product runs on the tensor cores.  At gemma3_4b's training call
// (B 1, S 2048, 8/4 heads of 320, causal) it is 53.7 GFLOP against 63 MB:
// 0.054 ms against 0.019, operations again.  This design does 3.5x the forward's (S and
// dP twice, once in each kernel), for three launches on the caller's
// stream, no atomics and every sum in a fixed order, so two calls give the
// same bits:
//   1. flash_bwd_delta_kernel: delta = rowsum(dO o O) in fp32, 16 bytes a
//      thread, D / 8 threads a row (8 at D 320, five pieces each);
//   2. flash_bwd_wgmma_dkdv_kernel, one block per (batch, K/V head, 64-key
//      tile), heaviest key tiles first: K and V come in once by TMA; a
//      producer warp streams the (Q, dO) tiles of every query head of the
//      group and every query tile that reaches the keys through a
//      two-stage mbarrier ring, with the tile's lse (in log2 units) and
//      delta beside them; the consumer warpgroup computes the transposed
//      products with the keys as wgmma's M rows: S^T = K Q^T and
//      dP^T = V dO^T with both operands K-major in shared memory, then
//      P^T and dS^T in the accumulator layout, which is the A-fragment
//      layout, rounded to bf16 in registers and fed to dV += P^T dO and
//      dK += dS^T Q with dO and Q read MN-major.  P and dS never touch
//      shared memory; dK and dV are summed over the G heads in registers,
//      dK scaled once, and rounded once in the epilogue;
//   3. flash_bwd_wgmma_dq_kernel, one block per (batch, query head, 64-row
//      query tile), as the forward: Q and dO come in once, K/V tiles
//      stream through the ring; S = Q K^T and dP = dO V^T from shared
//      memory, dS rounded to bf16 in registers into dQ += dS K with K read
//      MN-major.
// Roundings: P and dS to bf16 before the products that take them (fp32
// accumulation), each gradient once to bf16 at the end.
//
// Registers: a dK/dV thread holds D fp32 accumulators and S^T and dP^T
// (BQ / 2 each).  At D 128 the query tiles of that kernel are 32 rows, not
// 64, so that S^T and dP^T take 16 registers each and nothing spills; the
// keys stay 64, wgmma's M.
//
// D 320 (gemma3_4b) has no wgmma shape of 320 columns, so each product
// into a 320-wide output is five m64n64k16, one per 64-column block
// (wgmma_rs_wide), and dK and dV for 64 keys (2 x 160 fp32 a thread) do
// not fit one warpgroup's 255 registers.  So:
//   * flash_bwd_wgmma_dkdv_split_kernel gives them to two consumer
//     warpgroups of 240 registers a thread (setmaxnreg: the loading
//     warpgroup keeps 24): warpgroup V computes S^T = K Q^T, P^T and
//     dV += P^T dO; warpgroup K computes dP^T = V dO^T, reads the fp32 P^T
//     that V leaves in shared memory (two 8 KiB buffers, each with a
//     "full" mbarrier V -> K and an "empty" one K -> V, 128 arrivals each:
//     a wait that never ends traps after about ten seconds, where a named
//     barrier would hang), forms dS^T = P^T o (dP^T - delta) from it and
//     does dK += dS^T Q.  Each warpgroup does two of the four products a step,
//     and dS is formed from the fp32 P as at the other head dims.  Query
//     tiles stream at 32 rows, so S^T and dP^T take 16 registers each.
//     Shared memory: K and V 80 KiB, two stages of Q and dO 80 KiB, the
//     P^T buffers 16 KiB: 177 KiB, one block an SM.  At 288 threads (a
//     lone producer warp) ptxas capped the kernel at 168 registers, the
//     count of 384 threads, and it spilled 880 bytes and ran 2.3-2.7x
//     slower (scripts/flash_bwd_bench.py on an H100).
//   * the dQ kernel streams K/V tiles of 32 keys (BN 32), so S and dP take
//     16 registers each beside dQ's 160 (one warpgroup, one block an SM);
//     shared memory is Q and dO 80 KiB and two stages of K and V 80 KiB.
//
// Layouts (all contiguous, 16-byte aligned): q, o, do, dq (B, Sq, Hq, D);
// k, v, dk, dv (B, Sk, Hkv, D); lse (from the forward) and delta (scratch)
// (B, Hq, Sq) fp32.

#include <cstddef>
#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

using namespace repro::sm90;
using namespace repro::flash;

constexpr int kStages = 2;                // streamed tiles in flight
constexpr int kConsumers = 128;           // one warpgroup computes
constexpr int kThreads = kConsumers + 32; // and one warp loads
constexpr float kLog2e = 1.4426950408889634f;
// The D 320 dK/dV kernel: warpgroups V and K compute, a third warpgroup
// loads (one warp of it works).  The launch bounds give 168 registers a
// thread (65,536 over 384); the loaders give theirs up to 24 and the
// consumers take 240: 128 x 24 + 256 x 240 = 64,512.
constexpr int kSplitConsumers = 2 * kConsumers;
constexpr int kSplitThreads = kSplitConsumers + kConsumers;
constexpr uint32_t kLoadRegs = 24, kMmaRegs = 240;

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk, int causal,
                                        int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// dQ kernel: the query tile's Q and dO, two stages of K and V.  Every tile
// is a multiple of 1024 bytes, so each starts on a swizzle atom; the
// epilogue stages dQ (kBM rows of kOStride) over the K and V stages.
template <int D>
struct __align__(1024) DqSmem {
  static constexpr int kBK = D == 320 ? 32 : kBN;  // keys of a streamed tile
  bf16 q[kBM * D];
  bf16 dout[kBM * D];
  bf16 k[kStages][kBK * D];
  bf16 v[kStages][kBK * D];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

// dK/dV kernel: the key tile's K and V, two stages of Q, dO and their
// rows' lse (log2 units) and delta; the epilogue stages dK and dV (kBN rows
// of kOStride each) from the start, over K, V, Q and dO.
template <int D>
struct __align__(1024) DkvSmem {
  static constexpr int kBQ = D == 128 ? 32 : 64;  // query rows of a streamed tile
  bf16 k[kBN * D];
  bf16 v[kBN * D];
  bf16 q[kStages][kBQ * D];
  bf16 dout[kStages][kBQ * D];
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
};

// The D 320 dK/dV kernel: DkvSmem's tiles at 32 query rows, and two
// buffers of the fp32 P^T that warpgroup V hands to warpgroup K, each
// consumer thread's 16 values as four float4 (pt[b][j][t]: elements
// 4 j .. 4 j + 3 of thread t of the warpgroup), so that a warp's stores and
// loads are 512 contiguous bytes.  Buffer b's mbarriers: pt_full[b] (every
// thread of V has written it; an arrival releases its writes) and
// pt_empty[b] (every thread of K has read it).
template <int D>
struct __align__(1024) DkvSplitSmem {
  static constexpr int kBQ = 32;
  bf16 k[kBN * D];
  bf16 v[kBN * D];
  bf16 q[kStages][kBQ * D];
  bf16 dout[kStages][kBQ * D];
  float4 pt[2][kBQ / 8][kConsumers];
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
  uint64_t pt_full[2];
  uint64_t pt_empty[2];
};

template <typename S>
__device__ __forceinline__ S& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<S*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

// Threads a row of the delta kernel: one 16-byte piece each (4, 8 or 16,
// within one warp), or 8 at D 320 (40 pieces, five each).
template <int D>
__host__ __device__ constexpr int delta_threads() {
  return D / 8 <= 16 ? D / 8 : 8;
}

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int Sq, int Hq) {
  constexpr int kPer = delta_threads<D>();
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / kPer;  // (b, q, h) in q's layout
  const int piece = static_cast<int>(idx % kPer);
  float part = 0.f;
  if (row < rows) {
#pragma unroll
    for (int pc = piece; pc < D / 8; pc += kPer) {
      const int4 a = *reinterpret_cast<const int4*>(o + row * D + 8 * pc);
      const int4 c = *reinterpret_cast<const int4*>(dout + row * D + 8 * pc);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(x[j]), yf = __bfloat1622float2(y[j]);
        part += xf.x * yf.x + xf.y * yf.y;
      }
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (row < rows && piece == 0) {
    const long long bq = row / Hq;
    const int h = static_cast<int>(row % Hq);
    const long long b = bq / Sq;
    const int q = static_cast<int>(bq % Sq);
    delta[(b * Hq + h) * Sq + q] = part;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                            int Hkv, int G, int causal, int window, int q_offset,
                            float scale, float scale_log2) {
  using T = Tile<D>;
  using Sm = DkvSmem<D>;
  constexpr int BQ = Sm::kBQ;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv, Hq = Hkv * G;
  const int k0 = blockIdx.y * kBN;  // the first key tiles are seen by the most queries
  // Query tiles [t_lo, t_lo + nq) of BQ rows that see a key of the tile,
  // for each of the G heads: n steps.
  const int k_last = min(k0 + kBN, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int t_lo = q_lo / BQ;
  const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - t_lo : 0;
  const int n = G * nq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 32);  // every producer lane writes lse and delta
      mbar_init(&sm.empty[st], kConsumers / 32);
    }
    mbar_init(&sm.kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    if (n == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kBN * D * 2);
      for (int c = 0; c < T::kBlocks; ++c) {
        tma_load_4d(sm.k + c * kBN * T::kCols, &k_map, &sm.kv_full, c * T::kCols, kvh, k0, b);
        tma_load_4d(sm.v + c * kBN * T::kCols, &v_map, &sm.kv_full, c * T::kCols, kvh, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int h = kvh * G + i / nq, q0 = (t_lo + i % nq) * BQ;
      if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < Sq;
        const size_t idx = (static_cast<size_t>(b) * Hq + h) * Sq + q0 + r;
        sm.lse[st][r] = in ? lse[idx] * kLog2e : 0.f;
        sm.delta[st][r] = in ? delta[idx] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * BQ * D * 2);
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load_4d(sm.q[st] + c * BQ * T::kCols, &q_map, &sm.full[st], c * T::kCols, h,
                      q0, b);
          tma_load_4d(sm.dout[st] + c * BQ * T::kCols, &do_map, &sm.full[st], c * T::kCols,
                      h, q0, b);
        }
      } else {
        mbar_arrive(&sm.full[st]);
      }
    }
    return;
  }

  // The consumer warpgroup.  Accumulator layout (m64nN): thread (warp,
  // lane) holds rows (keys) 16 warp + lane / 4 (+ 8) and, for each 8-column
  // group j, columns (queries, or head dims in dK and dV) 8 j + 2 (lane % 4)
  // (+ 1): element e is row (e >> 1) & 1, group e >> 2, column e & 1.
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  if (n > 0) {
    const uint32_t k_base = smem_addr(sm.k), v_base = smem_addr(sm.v);
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) s[e] = dp[e] = 0.f;
    mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int q0 = (t_lo + i % nq) * BQ;
      mbar_wait(&sm.full[st], (i / kStages) & 1);
      const uint32_t q_base = smem_addr(sm.q[st]), do_base = smem_addr(sm.dout[st]);

      // S^T = K Q^T and dP^T = V dO^T, D in steps of 16.
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        reg_fence(s[e]);
        reg_fence(dp[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, kmajor_desc<D>(k_base, kBN, kk), kmajor_desc<D>(q_base, BQ, kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, kmajor_desc<D>(v_base, kBN, kk), kmajor_desc<D>(do_base, BQ, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        reg_fence(s[e]);
        reg_fence(dp[e]);
      }

      // P^T and dS^T in bf16; the mask only on edge tiles (queries past Sq
      // are zero rows of Q and dO, masked here all the same).
      const bool edge = k0 + kBN > Sk || q0 + BQ > Sq ||
                        (causal && k0 + kBN - 1 > q_offset + q0) ||
                        (window > 0 && k0 <= q_offset + q0 + BQ - 1 - window);
      uint32_t p[BQ / 4], ds[BQ / 4];
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {
        const int col = 8 * (e >> 2) + col0;  // query of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][col]);
        const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][col]);
        float p0 = exp2f(fmaf(s[e], scale_log2, -l2.x));
        float p1 = exp2f(fmaf(s[e + 1], scale_log2, -l2.y));
        if (edge) {
          const int kpos = k0 + row0 + 8 * ((e >> 1) & 1);
          const int qi = q0 + col, qpos = q_offset + qi;
          if (qi >= Sq || !visible(kpos, qpos, Sk, causal, window)) p0 = 0.f;
          if (qi + 1 >= Sq || !visible(kpos, qpos + 1, Sk, causal, window)) p1 = 0.f;
        }
        p[e / 2] = pack_bf16(p0, p1);
        ds[e / 2] = pack_bf16(p0 * (dp[e] - dl.x), p1 * (dp[e + 1] - dl.y));
      }

      // dV += P^T dO and dK += dS^T Q, queries in steps of 16: A fragment kk
      // is p[4 kk .. 4 kk + 3].
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        reg_fence(dk_acc[e]);
        reg_fence(dv_acc[e]);
      }
#pragma unroll
      for (int e = 0; e < BQ / 4; ++e) {
        reg_fence(p[e]);
        reg_fence(ds[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_rs<D>(dv_acc, a, mnmajor_desc<D>(do_base, BQ, kk));
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
        wgmma_rs<D>(dk_acc, a, mnmajor_desc<D>(q_base, BQ, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        reg_fence(dk_acc[e]);
        reg_fence(dv_acc[e]);
      }
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }
  }

  // Epilogue: dK * scale and dV in bf16 through shared memory, keys < Sk.
  // The staging tiles lie over K, V, Q and dO: every wgmma that read them
  // has completed, and the producer issued no load past the last tile (none
  // at all when n is 0).
  static_assert(2 * sizeof(bf16) * kBN * T::kOStride <= offsetof(Sm, lse),
                "the dK and dV tiles must fit before lse");
  bf16* const dk_s = reinterpret_cast<bf16*>(&sm);
  bf16* const dv_s = dk_s + kBN * T::kOStride;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int row = row0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + col0;
    *reinterpret_cast<uint32_t*>(&dk_s[row * T::kOStride + col]) =
        pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
    *reinterpret_cast<uint32_t*>(&dv_s[row * T::kOStride + col]) =
        pack_bf16(dv_acc[e], dv_acc[e + 1]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  for (int idx = tid; idx < kBN * kPieces; idx += kConsumers) {
    const int row = idx / kPieces, c = idx % kPieces;
    if (k0 + row < Sk) {
      const size_t off = ((static_cast<size_t>(b) * Sk + k0 + row) * Hkv + kvh) * D + 8 * c;
      *reinterpret_cast<int4*>(dk + off) =
          *reinterpret_cast<const int4*>(&dk_s[row * T::kOStride + 8 * c]);
      *reinterpret_cast<int4*>(dv + off) =
          *reinterpret_cast<const int4*>(&dv_s[row * T::kOStride + 8 * c]);
    }
  }
}

// dK/dV at D 320 over two consumer warpgroups (the header note): warpgroup
// V (threads 0-127) holds dV and computes S^T, P^T and dV += P^T dO;
// warpgroup K (128-255) holds dK and computes dP^T, dS^T from V's fp32 P^T
// and dK += dS^T Q; the producer warpgroup's first warp (256-287) loads as
// in the kernel above.  Each (Q, dO) stage is released when all eight consumer warps
// have done with it.
template <int D>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_wgmma_dkdv_split_kernel(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __grid_constant__ CUtensorMap do_map,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int Sq, int Sk, int Hkv, int G,
                                  int causal, int window, int q_offset, float scale,
                                  float scale_log2) {
  using T = Tile<D>;
  using Sm = DkvSplitSmem<D>;
  constexpr int BQ = Sm::kBQ;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv, Hq = Hkv * G;
  const int k0 = blockIdx.y * kBN;
  const int k_last = min(k0 + kBN, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int t_lo = q_lo / BQ;
  const int nq = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - t_lo : 0;
  const int n = G * nq;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 32);  // every producer lane writes lse and delta
      mbar_init(&sm.empty[st], kSplitConsumers / 32);
    }
    mbar_init(&sm.kv_full, 1);
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(&sm.pt_full[buf], kConsumers);
      mbar_init(&sm.pt_empty[buf], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kSplitConsumers) {  // the producer warpgroup: its first warp loads
    setmaxnreg_dec<kLoadRegs>();
    const int lane = tid - kSplitConsumers;
    if (n == 0 || lane >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kBN * D * 2);
      for (int c = 0; c < T::kBlocks; ++c) {
        tma_load_4d(sm.k + c * kBN * T::kCols, &k_map, &sm.kv_full, c * T::kCols, kvh, k0, b);
        tma_load_4d(sm.v + c * kBN * T::kCols, &v_map, &sm.kv_full, c * T::kCols, kvh, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int h = kvh * G + i / nq, q0 = (t_lo + i % nq) * BQ;
      if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < Sq;
        const size_t idx = (static_cast<size_t>(b) * Hq + h) * Sq + q0 + r;
        sm.lse[st][r] = in ? lse[idx] * kLog2e : 0.f;
        sm.delta[st][r] = in ? delta[idx] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[st], 2 * BQ * D * 2);
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load_4d(sm.q[st] + c * BQ * T::kCols, &q_map, &sm.full[st], c * T::kCols, h,
                      q0, b);
          tma_load_4d(sm.dout[st] + c * BQ * T::kCols, &do_map, &sm.full[st], c * T::kCols,
                      h, q0, b);
        }
      } else {
        mbar_arrive(&sm.full[st]);
      }
    }
    return;
  }

  // The consumer warpgroups, in the accumulator layout of the kernel above
  // (rows are keys; columns queries in S^T, P^T, dP^T, head dims in dK and
  // dV).  A thread of V and the thread of K at the same place in its
  // warpgroup hold the same elements of P^T and dP^T.
  setmaxnreg_inc<kMmaRegs>();
  const int wg = tid / kConsumers;  // 0: warpgroup V, 1: warpgroup K
  const int t = tid % kConsumers;
  const int warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float acc[D / 2];  // dV in V, dK (unscaled) in K
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  if (n > 0) {
    // V: S^T = K Q^T, then dV += P^T dO; K: dP^T = V dO^T, then dK += dS^T Q.
    const uint32_t a_base = smem_addr(wg == 0 ? sm.k : sm.v);
    float s[BQ / 2];  // S^T in V, dP^T in K
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) s[e] = 0.f;
    mbar_wait(&sm.kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages, buf = i % 2;
      const int q0 = (t_lo + i % nq) * BQ;
      mbar_wait(&sm.full[st], (i / kStages) & 1);
      const uint32_t q_base = smem_addr(sm.q[st]), do_base = smem_addr(sm.dout[st]);
      const uint32_t b_base = wg == 0 ? q_base : do_base;  // of the first product
      const uint32_t m_base = wg == 0 ? do_base : q_base;  // of the second

#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) reg_fence(s[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, kmajor_desc<D>(a_base, kBN, kk), kmajor_desc<D>(b_base, BQ, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) reg_fence(s[e]);

      uint32_t frag[BQ / 4];  // P^T (V) or dS^T (K) in bf16: the A fragments
      if (wg == 0) {
        // P^T, masked on edge tiles as in the kernel above; the fp32 values
        // to K through buffer buf, once K has read what it held two steps
        // ago.
        const bool edge = k0 + kBN > Sk || q0 + BQ > Sq ||
                          (causal && k0 + kBN - 1 > q_offset + q0) ||
                          (window > 0 && k0 <= q_offset + q0 + BQ - 1 - window);
        if (i >= 2) mbar_wait(&sm.pt_empty[buf], (i / 2 - 1) & 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col = 8 * j + col0;  // query of the tile
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][col]);
          float p[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            p[m] = exp2f(fmaf(s[4 * j + m], scale_log2, (m & 1) ? -l2.y : -l2.x));
            if (edge) {
              const int kpos = k0 + row0 + 8 * (m >> 1);
              const int qi = q0 + col + (m & 1);
              if (qi >= Sq || !visible(kpos, q_offset + qi, Sk, causal, window)) p[m] = 0.f;
            }
          }
          sm.pt[buf][j][t] = make_float4(p[0], p[1], p[2], p[3]);
          frag[2 * j] = pack_bf16(p[0], p[1]);
          frag[2 * j + 1] = pack_bf16(p[2], p[3]);
        }
        mbar_arrive(&sm.pt_full[buf]);
      } else {
        // dS^T = P^T o (dP^T - delta) from V's fp32 P^T; buffer buf is free
        // for V's step i + 2 once read.
        mbar_wait(&sm.pt_full[buf], (i / 2) & 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float4 p = sm.pt[buf][j][t];
          const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][8 * j + col0]);
          frag[2 * j] = pack_bf16(p.x * (s[4 * j] - dl.x), p.y * (s[4 * j + 1] - dl.y));
          frag[2 * j + 1] =
              pack_bf16(p.z * (s[4 * j + 2] - dl.x), p.w * (s[4 * j + 3] - dl.y));
        }
        mbar_arrive(&sm.pt_empty[buf]);
      }

      // dV += P^T dO (V) or dK += dS^T Q (K), queries in steps of 16: A
      // fragment kk is frag[4 kk .. 4 kk + 3].
#pragma unroll
      for (int e = 0; e < D / 2; ++e) reg_fence(acc[e]);
#pragma unroll
      for (int e = 0; e < BQ / 4; ++e) reg_fence(frag[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {frag[4 * kk], frag[4 * kk + 1], frag[4 * kk + 2],
                               frag[4 * kk + 3]};
        wgmma_rs_wide<D>(acc, a, m_base, BQ, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) reg_fence(acc[e]);
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }
  }

  // Epilogue: dV and dK * scale in bf16 through shared memory (dV's tile
  // first, then dK's), keys < Sk.  The tiles lie over K, V and the first
  // Q stage: the barrier waits until both warpgroups' wgmmas that read
  // them have completed, and the producer issued no load past the last
  // tile (none at all when n is 0).
  static_assert(2 * sizeof(bf16) * kBN * T::kOStride <= offsetof(Sm, pt),
                "the dK and dV tiles must fit before the P^T buffers");
  asm volatile("bar.sync 1, %0;\n" :: "n"(kSplitConsumers) : "memory");
  bf16* const out_s = reinterpret_cast<bf16*>(&sm) + wg * kBN * T::kOStride;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int row = row0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + col0;
    *reinterpret_cast<uint32_t*>(&out_s[row * T::kOStride + col]) =
        pack_bf16(acc[e] * mul, acc[e + 1] * mul);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kSplitConsumers) : "memory");
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  const bf16* const staged = reinterpret_cast<const bf16*>(&sm);
  for (int idx = tid; idx < 2 * kBN * kPieces; idx += kSplitConsumers) {
    const int which = idx / (kBN * kPieces);  // 0: dV, 1: dK
    const int row = idx % (kBN * kPieces) / kPieces, c = idx % kPieces;
    if (k0 + row < Sk) {
      const size_t off = ((static_cast<size_t>(b) * Sk + k0 + row) * Hkv + kvh) * D + 8 * c;
      *reinterpret_cast<int4*>((which == 0 ? dv : dk) + off) = *reinterpret_cast<const int4*>(
          &staged[(which * kBN + row) * T::kOStride + 8 * c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 320 ? 1 : 2)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Sk, int Hq, int G, int causal,
                          int window, int q_offset, float scale, float scale_log2) {
  using T = Tile<D>;
  using Sm = DqSmem<D>;
  constexpr int BK = Sm::kBK;
  extern __shared__ uint8_t smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const KeyRange kr = key_range(q0, Sq, Sk, causal, window, q_offset, BK);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers / 32);
    }
    mbar_init(&sm.q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues every load
    if (tid == kConsumers && kr.n > 0) {
      mbar_arrive_expect_tx(&sm.q_full, 2 * kBM * D * 2);
      for (int c = 0; c < T::kBlocks; ++c) {
        tma_load_4d(sm.q + c * kBM * T::kCols, &q_map, &sm.q_full, c * T::kCols, h, q0, b);
        tma_load_4d(sm.dout + c * kBM * T::kCols, &do_map, &sm.q_full, c * T::kCols, h, q0,
                    b);
      }
      for (int i = 0; i < kr.n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * BK * D * 2);
        const int k0 = kr.lo + i * BK;
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load_4d(sm.k[st] + c * BK * T::kCols, &k_map, &sm.full[st], c * T::kCols,
                      kvh, k0, b);
          tma_load_4d(sm.v[st] + c * BK * T::kCols, &v_map, &sm.full[st], c * T::kCols,
                      kvh, k0, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup; the forward's accumulator layout (rows are
  // queries).
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int qpos0 = q_offset + q0 + row0;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    const size_t idx = (static_cast<size_t>(b) * Hq + h) * Sq + qi;
    lse_r[r] = qi < Sq ? lse[idx] * kLog2e : 0.f;
    delta_r[r] = qi < Sq ? delta[idx] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.f;

  if (kr.n > 0) {
    const uint32_t q_base = smem_addr(sm.q), do_base = smem_addr(sm.dout);
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.f;
    mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < kr.n; ++i) {
      const int st = i % kStages;
      mbar_wait(&sm.full[st], (i / kStages) & 1);
      const uint32_t k_base = smem_addr(sm.k[st]), v_base = smem_addr(sm.v[st]);

      // S = Q K^T and dP = dO V^T, D in steps of 16.
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        reg_fence(s[e]);
        reg_fence(dp[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(s, kmajor_desc<D>(q_base, kBM, kk), kmajor_desc<D>(k_base, BK, kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, kmajor_desc<D>(do_base, kBM, kk), kmajor_desc<D>(v_base, BK, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        reg_fence(s[e]);
        reg_fence(dp[e]);
      }

      // dS in bf16; the mask only on edge tiles.
      const int k0 = kr.lo + i * BK;
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q_offset + q0) ||
                        (window > 0 && k0 <= q_offset + q0 + kBM - 1 - window);
      uint32_t ds[BK / 4];
#pragma unroll
      for (int e = 0; e < BK / 2; e += 2) {
        const int r = (e >> 1) & 1;
        float p0 = exp2f(fmaf(s[e], scale_log2, -lse_r[r]));
        float p1 = exp2f(fmaf(s[e + 1], scale_log2, -lse_r[r]));
        if (edge) {
          const int kpos = k0 + 8 * (e >> 2) + col0, qpos = qpos0 + 8 * r;
          if (!visible(kpos, qpos, Sk, causal, window)) p0 = 0.f;
          if (!visible(kpos + 1, qpos, Sk, causal, window)) p1 = 0.f;
        }
        ds[e / 2] = pack_bf16(p0 * (dp[e] - delta_r[r]), p1 * (dp[e + 1] - delta_r[r]));
      }

      // dQ += dS K, keys in steps of 16.
#pragma unroll
      for (int e = 0; e < D / 2; ++e) reg_fence(dq_acc[e]);
#pragma unroll
      for (int e = 0; e < BK / 4; ++e) reg_fence(ds[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
        wgmma_rs_wide<D>(dq_acc, a, k_base, BK, kk);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) reg_fence(dq_acc[e]);
      if (lane == 0) mbar_arrive(&sm.empty[st]);
    }
  }

  // Epilogue: dQ * scale in bf16 through shared memory, rows < Sq; the
  // staging tile lies over the K and V stages (their first 42 KiB at D 320).
  static_assert(offsetof(Sm, full) - offsetof(Sm, k) >= sizeof(bf16) * kBM * T::kOStride,
                "the dQ tile must fit over the K and V stages");
  bf16* const dq_s = sm.k[0];
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int row = row0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + col0;
    *reinterpret_cast<uint32_t*>(&dq_s[row * T::kOStride + col]) =
        pack_bf16(dq_acc[e] * scale, dq_acc[e + 1] * scale);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  constexpr int kPieces = D / 8;
  for (int idx = tid; idx < kBM * kPieces; idx += kConsumers) {
    const int row = idx / kPieces, c = idx % kPieces;
    if (q0 + row < Sq) {
      const size_t off = ((static_cast<size_t>(b) * Sq + q0 + row) * Hq + h) * D + 8 * c;
      *reinterpret_cast<int4*>(dq + off) =
          *reinterpret_cast<const int4*>(&dq_s[row * T::kOStride + 8 * c]);
    }
  }
}

template <typename S>
constexpr int smem_bytes() {
  return sizeof(S) + 1024;  // + alignment slack
}

// The dK/dV kernel of head dim D and its shared memory.
template <int D>
using DkvSm = std::conditional_t<D == 320, DkvSplitSmem<D>, DkvSmem<D>>;

template <int D>
inline auto dkdv_kernel() {
  if constexpr (D == 320) {
    return flash_bwd_wgmma_dkdv_split_kernel<D>;
  } else {
    return flash_bwd_wgmma_dkdv_kernel<D>;
  }
}

// Lets the instances for D use their dynamic shared memory: a setting of
// the functions, made once before the first launch.
template <int D>
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<D>(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<DkvSm<D>>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_wgmma_dq_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<DqSmem<D>>());
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, const float* lse,
                   float* delta, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr int BQ = DkvSm<D>::kBQ, BK = DqSmem<D>::kBK;
  constexpr int dkdv_threads = D == 320 ? kSplitThreads : kThreads;
  // q and do by 64-row tiles (dQ) and BQ-row tiles (dK/dV); k and v by
  // 64-key tiles (dK/dV) and BK-key tiles (dQ).
  CUtensorMap q_map, do_map, qt_map, dot_map, k_map, v_map, kt_map, vt_map;
  if (!make_map(&q_map, q, B, Sq, Hq, D, kBM) || !make_map(&do_map, dout, B, Sq, Hq, D, kBM) ||
      !make_map(&qt_map, q, B, Sq, Hq, D, BQ) || !make_map(&dot_map, dout, B, Sq, Hq, D, BQ) ||
      !make_map(&k_map, k, B, Sk, Hkv, D, kBN) || !make_map(&v_map, v, B, Sk, Hkv, D, kBN) ||
      !make_map(&kt_map, k, B, Sk, Hkv, D, BK) || !make_map(&vt_map, v, B, Sk, Hkv, D, BK))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;

  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long threads = rows * delta_threads<D>();
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, rows, Sq, Hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 dkdv_grid(B * Hkv, (Sk + kBN - 1) / kBN);
  const auto dkdv = dkdv_kernel<D>();
  dkdv<<<dkdv_grid, dkdv_threads, smem_bytes<DkvSm<D>>(), stream>>>(
      qt_map, k_map, v_map, dot_map, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, Hkv, Hq / Hkv, causal, window, q_offset, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 dq_grid(B * Hq, (Sq + kBM - 1) / kBM);
  flash_bwd_wgmma_dq_kernel<D><<<dq_grid, kThreads, smem_bytes<DqSmem<D>>(), stream>>>(
      q_map, kt_map, vt_map, do_map, lse, delta, static_cast<bf16*>(dq), Sq, Sk, Hq,
      Hq / Hkv, causal, window, q_offset, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Once per process and device, before the first launch: raises each
// instance's dynamic shared-memory limit to what it uses.  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_wgmma_setup() {
  cudaError_t err = allow_smem<32>();
  if (err == cudaSuccess) err = allow_smem<64>();
  if (err == cudaSuccess) err = allow_smem<128>();
  if (err == cudaSuccess) err = allow_smem<320>();
  return static_cast<int>(err);
}

// bf16 q, k, v, o, do, dq, dk, dv; lse the forward's fp32 (B, Hq, Sq)
// log-sum-exp of each row (natural log), delta fp32 (B, Hq, Sq) scratch.
// window <= 0 means no window.  Head dims 32, 64, 128 and 320 are
// compiled; flash_attention_bwd_wgmma_setup must have run on the current
// device.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_wgmma_launch(const void* q, const void* k,
                                                const void* v, const void* o,
                                                const void* dout, void* dq, void* dk,
                                                void* dv, const void* lse, void* delta,
                                                int B, int Sq, int Sk, int Hq, int Hkv,
                                                int D, int causal, int window,
                                                int q_offset, float scale, void* stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk, Hq, Hkv, causal,
                       window, q_offset, scale, s);
      break;
    case 64:
      err = launch<64>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk, Hq, Hkv, causal,
                       window, q_offset, scale, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk, Hq, Hkv, causal,
                        window, q_offset, scale, s);
      break;
    case 320:
      err = launch<320>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk, Hq, Hkv, causal,
                        window, q_offset, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
