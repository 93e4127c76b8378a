// Chunked gated linear attention (GLA) scan on Hopper's tensor cores
// (sm_90a, warp-level mma.sync), for bf16 q/k/v with K = V = 64.
//
// Replaces gla_scan_pallas / _gla_kernel (src/repro/kernels/ssm_scan/
// kernel.py:76, pallas_call at :90) on the calls the models make (RWKV6 and
// Mamba2 heads of 64, chunk 128); every other call takes the CUDA-core
// kernel in gla_scan.cu, by the rule in kernels/ssm_scan/kernel.py::route.
// It computes what gla_scan_xla (kernels/ssm_scan/ops.py) computes, from a
// zero state.  Per chunk of C positions, for each (batch, head):
//   w <- clamp(w, -30, 0);  a = cumsum(w) within the chunk
//   q~ = q * e^a;  k~ = k * e^min(-a, 60)
//   o  = causal(q~ k~^T) v + q~ S
//   S <- e^{a_last} (S + k~^T v)
// The last line is the plain version's e^{a_last} S + (k~ e^{a_last})^T v
// with the row scale taken out of the product, so k~ is the one key operand
// of both the scores and the state update.  The exponent guard min(-a, 60)
// is the reference's, copied on purpose (ROADMAP.md, Queue 3).
//
// Precision.  Every product runs on the tensor cores as mma.sync m16n8k16
// with bf16 operands and fp32 accumulation.  v is bf16 already and exact.
// Every operand formed in fp32 (q~, k~, the scores, S) is split into
// hi = bf16(x) and lo = bf16(x - hi), which together carry about 16
// significant bits; a product of two such operands takes three MMAs
// (hi hi + hi lo + lo hi), a product with v two.  bf16 has fp32's exponent
// range, so k~'s factor up to e^60 costs no range, and every kept term
// q_k k_k e^{a_i - a_j} has a factor <= 1.  Rounding the operands once to
// bf16 instead puts the fp32 state outside its 1e-3 tolerance.  The torch
// emulation mma_emulation in tests/test_torch_gla_route.py shows both: it
// repeats these roundings product by product, and its docstring names the
// lines of this file that each of its lines follows, so an edit to which
// operands are split here is made there too.  The causal mask
// is a select, never a multiply by 0: the masked triangle holds factors up
// to e^60.
//
// Layout.  One block of four warps per (batch, head) walks its chunks in
// order, as the Pallas kernel's sequential chunk axis does.  S (64 x 64
// fp32) stays in registers across chunks: warp i owns its rows 16i..16i+15
// as eight m16n8 accumulators, 32 floats a thread.  For the cross term the
// block also keeps S as bf16 hi/lo tiles in shared memory, written after
// each state update.  Per chunk:
//   1. cp.async 16-byte copies bring q, k and v (bf16) into shared memory;
//      rows at or past S arrive as zeros (the plain version's padding, with
//      w = 0 there, so e^{a_last} is the last real row's);
//   2. the decay runs in parallel: warp i sums the clamped w of its quarter
//      of the rows for two columns a lane, the four partial sums are
//      combined through shared memory, then each lane walks its rows again
//      forming q~ and k~ in fp32 and writing them back as hi/lo tiles (q~
//      hi over q, k~ hi over k).  w (fp32, the largest input) is loaded
//      into registers a chunk ahead, so its loads are in flight while the
//      products of the chunk before run.  A stride-0 K axis of w (Mamba2:
//      one decay per head) is read once per row, every lane from the same
//      address;
//   3. warp i takes query tiles i and 7 - i (16 rows each), so the causal
//      triangle gives every warp 9 of the 36 score tiles at C = 128.  For a
//      query tile: q~ S from the hi/lo tiles of S (three MMAs), then, for
//      each 16-key block on or below the diagonal, the scores (three MMAs
//      over K) are masked on the diagonal block, split hi/lo in registers
//      and used as A fragments (the m16n8 accumulator layout of two n-tiles
//      is the m16k16 A layout), times v from ldmatrix.trans (two MMAs).
//      Key blocks above the diagonal are skipped.  The output is stored as
//      bf16;
//   4. the state update k~^T v (two MMAs per step: k~ hi and lo, read
//      transposed by ldmatrix.trans) accumulates into S's registers, which
//      are then scaled by e^{a_last} per row.
// Rows of 64 bf16 are padded to 72 in shared memory, so the eight 16-byte
// rows an ldmatrix reads fall in distinct banks.  There is one load
// buffer: 111,872 bytes of shared memory at C = 128, so two blocks share an
// SM and one block's loads and decay pass overlap the other's products.  A
// second buffer (167,168 bytes, one block an SM, the next chunk's q, k and
// v in flight) was measured once on an H100 at the RWKV6 prefill shape and
// was 31% slower, 0.2074 against 0.1428 ms (PERF.md, section 6): the kernel
// waits on latency more than on bytes, and two blocks hide more of it.
// ptxas gives 239 registers a thread and no spills.  Each chunk waits
// for its own copies with cp.async.wait_group 0: there is no spin.
//
// Bound.  At the RWKV6 prefill shape (B 8, H 64, S 512, bf16 q/k/v, fp32 w)
// the call must move about 210 MB (0.0626 ms at 3.35 TB/s); its products,
// with the hi/lo splits, are about 23 GFLOP of tensor-core work (0.023 ms
// at 989 TFLOP/s), so bytes bind it.  chip_smoke.py computes both.
//
// Strides.  q, k, v and w arrive as (B, H, S, *) views with a contiguous
// last axis; q, k and v 16-byte aligned with B, H and S strides that are
// multiples of 8 elements (cp.async copies 16 bytes); w (fp32) with any
// strides and a K stride of 0 or 1.  o (B, H, S, 64) and the final state
// (B, H, 64, 64) are contiguous.

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
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 128;
constexpr int kLd = kDim + 8;            // padded bf16 row of shared memory
constexpr int kRowsPerWarp = kMaxChunk / kWarps;
constexpr float kClamp = 30.f;           // w is clamped to [-kClamp, 0]
constexpr float kGuard = 60.f;           // exp(-a) saturates at e^kGuard

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* w;
  bf16* o;
  float* state;
  int H, S, C;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, w_b, w_h, w_s, w_k;
};

// Shared memory of one block: the load buffer of {q, k, v} (C rows each),
// the lo tiles of q~ and k~, S's hi and lo tiles (64 rows), the decay's
// partial sums (4 x 64) and e^{a_last} (64).
inline size_t smem_bytes(int C) {
  return sizeof(bf16) * ((size_t)5 * C * kLd + 2 * kDim * kLd)
         + sizeof(float) * (kWarps + 1) * kDim;
}

__global__ void __launch_bounds__(kThreads) gla_scan_mma_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, S = p.S;
  const int tile = C * kLd;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // q, then q~ hi
  bf16* k_s = q_s + tile;                          // k, then k~ hi
  bf16* v_s = k_s + tile;
  bf16* q_lo = v_s + tile;
  bf16* k_lo = q_lo + tile;
  bf16* s_hi = k_lo + tile;                          // [kDim][kLd]
  bf16* s_lo = s_hi + kDim * kLd;
  float* part = reinterpret_cast<float*>(s_lo + kDim * kLd);  // [kWarps][kDim]
  float* ea_s = part + kWarps * kDim;                         // [kDim]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;  // MMA fragment row and column pair
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  const bf16* qb = p.q + b * p.q_b + h * p.q_h;
  const bf16* kb = p.k + b * p.k_b + h * p.k_h;
  const bf16* vb = p.v + b * p.v_b + h * p.v_h;
  const float* wb = p.w + b * p.w_b + h * p.w_h;
  bf16* ob = p.o + (size_t)bh * S * kDim;
  const int n_chunks = (S + C - 1) / C;
  const int n_tiles = C / 16;
  const int rows_per_warp = C / kWarps;

  // Issue the copies of chunk `c` into the load buffer, as one group.
  auto load = [&](int c) {
    for (int i = tid; i < C * 8; i += kThreads) {
      const int r = i >> 3, col = (i & 7) * 8;
      const long long pos = (long long)c * C + r;
      const bool ok = pos < S;
      const long long at = ok ? pos : 0;
      cp_async16(q_s + r * kLd + col, qb + at * p.q_s + col, ok);
      cp_async16(k_s + r * kLd + col, kb + at * p.k_s + col, ok);
      cp_async16(v_s + r * kLd + col, vb + at * p.v_s + col, ok);
    }
    cp_async_commit();
  };

  float st[8][4];  // S rows 16 warp + {g, g + 8}, columns 8 n + 2 cq + {0, 1}
#pragma unroll
  for (int n = 0; n < 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
  for (int i = tid; i < 2 * kDim * kLd; i += kThreads) s_hi[i] = __float2bfloat16(0.f);
  load(0);
  // Raw w of chunk c for this warp's rows, columns 2 lane and 2 lane + 1.
  // The loads are unconditional (row 0 stands in for rows outside the
  // chunk), so that all are in flight before the first is used.
  float w0[kRowsPerWarp], w1[kRowsPerWarp];
  auto fetch_w = [&](int c) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const long long pos = (long long)c * C + warp * rows_per_warp + i;
      const bool ok = i < rows_per_warp && pos < S;
      const float* wr = wb + (ok ? pos : 0) * p.w_s;
      w0[i] = wr[(2 * lane) * p.w_k];
      w1[i] = wr[(2 * lane + 1) * p.w_k];
    }
  };
  fetch_w(0);

  for (int c = 0; c < n_chunks; ++c) {
    const long long c0 = (long long)c * C;
    const int r0 = warp * rows_per_warp;

    // 1. Decay, first pass: w of this warp's rows clamped (zero past the
    //    chunk and past S), and its sums.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const long long pos = c0 + r0 + i;
      const bool ok = i < rows_per_warp && pos < S;
      w0[i] = ok ? fminf(fmaxf(w0[i], -kClamp), 0.f) : 0.f;
      w1[i] = ok ? fminf(fmaxf(w1[i], -kClamp), 0.f) : 0.f;
      sum0 += w0[i];
      sum1 += w1[i];
    }
    part[warp * kDim + 2 * lane] = sum0;
    part[warp * kDim + 2 * lane + 1] = sum1;
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles and the partial sums are in

    // 2. Second pass: the running decay from the earlier warps' sums, then
    //    q~ and k~ of each row, written back as hi/lo tiles.
    float a0 = 0.f, a1 = 0.f, last0 = 0.f, last1 = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const float s0 = part[j * kDim + 2 * lane], s1 = part[j * kDim + 2 * lane + 1];
      if (j < warp) {
        a0 += s0;
        a1 += s1;
      }
      last0 += s0;
      last1 += s1;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i < rows_per_warp) {
        a0 += w0[i];
        a1 += w1[i];
        const int at = (r0 + i) * kLd + 2 * lane;
        const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q_s + at));
        const float2 kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k_s + at));
        uint32_t hi, lo;
        split2(qv.x * expf(a0), qv.y * expf(a1), hi, lo);
        store_u32(q_s + at, hi);
        store_u32(q_lo + at, lo);
        split2(kv.x * expf(fminf(-a0, kGuard)), kv.y * expf(fminf(-a1, kGuard)), hi, lo);
        store_u32(k_s + at, hi);
        store_u32(k_lo + at, lo);
      }
    }
    fetch_w(c + 1);  // in flight through the products below
    if (warp == 0) {
      ea_s[2 * lane] = expf(last0);
      ea_s[2 * lane + 1] = expf(last1);
    }
    __syncthreads();  // q~, k~ and e^{a_last} are in

    // 3. Outputs of query tiles warp and 7 - warp.
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int t = pass == 0 ? warp : 7 - warp;
      if (t >= n_tiles) continue;
      uint32_t qh[4][4], ql[4][4];  // A fragments of q~, one per 16 of K
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int at = (16 * t + (lm & 1) * 8 + lr) * kLd + 16 * ks + (lm >> 1) * 8;
        ldsm_x4(qh[ks], q_s + at);
        ldsm_x4(ql[ks], q_lo + at);
      }
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

      // Cross-chunk term q~ S (S stored [K][V]: B read transposed).
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int at = (16 * ks + (lm & 1) * 8 + lr) * kLd + 16 * np + (lm >> 1) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, s_hi + at);
          ldsm_x4_t(bl, s_lo + at);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mma(acc[2 * np + e], qh[ks], bh[2 * e], bh[2 * e + 1]);
            mma(acc[2 * np + e], qh[ks], bl[2 * e], bl[2 * e + 1]);
            mma(acc[2 * np + e], ql[ks], bh[2 * e], bh[2 * e + 1]);
          }
        }
      }

      // Intra-chunk term: 16-key blocks on or below the diagonal.
#pragma unroll 1
      for (int j = 0; j <= t; ++j) {
        float s3[3][2][4];  // hi hi, hi lo, lo hi: six independent chains
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) s3[u][e][0] = s3[u][e][1] = s3[u][e][2] = s3[u][e][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // k~ stored [key][K]: B read as is
          const int at = (16 * j + (lm >> 1) * 8 + lr) * kLd + 16 * ks + (lm & 1) * 8;
          uint32_t kh[4], kl[4];
          ldsm_x4(kh, k_s + at);
          ldsm_x4(kl, k_lo + at);
#pragma unroll
          for (int e = 0; e < 2; ++e) mma(s3[0][e], qh[ks], kh[2 * e], kh[2 * e + 1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) mma(s3[1][e], qh[ks], kl[2 * e], kl[2 * e + 1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) mma(s3[2][e], ql[ks], kh[2 * e], kh[2 * e + 1]);
        }
        float sc[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[e][x] = s3[0][e][x] + (s3[1][e][x] + s3[2][e][x]);
        if (j == t) {  // keep key <= query: a select, never a multiply
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int row = g + (x >> 1) * 8, key = 8 * e + 2 * cq + (x & 1);
              sc[e][x] = key > row ? 0.f : sc[e][x];
            }
          }
        }
        uint32_t ah[4], al[4];
        split2(sc[0][0], sc[0][1], ah[0], al[0]);
        split2(sc[0][2], sc[0][3], ah[1], al[1]);
        split2(sc[1][0], sc[1][1], ah[2], al[2]);
        split2(sc[1][2], sc[1][3], ah[3], al[3]);
        uint32_t bv[4][4];  // v stored [key][V]: B read transposed
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldsm_x4_t(bv[np], v_s + (16 * j + (lm & 1) * 8 + lr) * kLd + 16 * np + (lm >> 1) * 8);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma(acc[n], ah, bv[n >> 1][2 * (n & 1)], bv[n >> 1][2 * (n & 1) + 1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma(acc[n], al, bv[n >> 1][2 * (n & 1)], bv[n >> 1][2 * (n & 1) + 1]);
      }

      const long long row = c0 + 16 * t + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * cq;
        if (row < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * kDim + col) =
              __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        if (row + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (row + 8) * kDim + col) =
              __floats2bfloat162_rn(acc[n][2], acc[n][3]);
      }
    }

    // 4. State update S <- e^{a_last} (S + k~^T v) on this warp's 16 rows
    //    of S: A = k~^T (k~ stored [key][K], read transposed), B = v.
#pragma unroll 2
    for (int rs = 0; rs < n_tiles; ++rs) {
      const int at = (16 * rs + (lm >> 1) * 8 + lr) * kLd + 16 * warp + (lm & 1) * 8;
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, k_s + at);
      ldsm_x4_t(al, k_lo + at);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_s + (16 * rs + (lm & 1) * 8 + lr) * kLd + 16 * np + (lm >> 1) * 8);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mma(st[2 * np + e], ah, bv[2 * e], bv[2 * e + 1]);
          mma(st[2 * np + e], al, bv[2 * e], bv[2 * e + 1]);
        }
      }
    }
    const float e0 = ea_s[16 * warp + g], e1 = ea_s[16 * warp + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st[n][0] *= e0;
      st[n][1] *= e0;
      st[n][2] *= e1;
      st[n][3] *= e1;
    }
    __syncthreads();  // every read of this chunk's tiles and of the old S is done

    if (c + 1 < n_chunks) {  // the new S as hi/lo tiles for the next cross term
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int at = (16 * warp + g) * kLd + 8 * n + 2 * cq;
        uint32_t hi, lo;
        split2(st[n][0], st[n][1], hi, lo);
        store_u32(s_hi + at, hi);
        store_u32(s_lo + at, lo);
        split2(st[n][2], st[n][3], hi, lo);
        store_u32(s_hi + at + 8 * kLd, hi);
        store_u32(s_lo + at + 8 * kLd, lo);
      }
    }
    if (c + 1 < n_chunks) load(c + 1);
  }

  float* sp = p.state + (size_t)bh * kDim * kDim;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int row = 16 * warp + g, col = 8 * n + 2 * cq;
    *reinterpret_cast<float2*>(sp + row * kDim + col) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(sp + (row + 8) * kDim + col) = make_float2(st[n][2], st[n][3]);
  }
}

cudaError_t launch(const Args& p, int BH, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.C);
  cudaError_t err = cudaFuncSetAttribute(gla_scan_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gla_scan_mma_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  gla_scan_mma_kernel<<<BH, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// bf16 q, k, v (B, H, S, 64), fp32 w (B, H, S, 64); 16 <= C <= 128 with
// C % 16 == 0 (C = min(chunk, S)); strides in elements, (B, H, S) for q, k
// and v, (B, H, S, K) for w.  Returns a cudaError_t.
extern "C" int gla_scan_mma_launch(const void* q, const void* k, const void* v,
                                   const void* w, void* o, void* state, int B,
                                   int H, int S, int C, long long q_b,
                                   long long q_h, long long q_s, long long k_b,
                                   long long k_h, long long k_s, long long v_b,
                                   long long v_h, long long v_s, long long w_b,
                                   long long w_h, long long w_s, long long w_k,
                                   void* stream) {
  const long long strides[] = {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s};
  bool ok = C >= 16 && C <= kMaxChunk && C % 16 == 0 && (w_k == 0 || w_k == 1)
            && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(w),
         static_cast<bf16*>(o), static_cast<float*>(state), H, S, C,
         q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, w_b, w_h, w_s, w_k};
  return static_cast<int>(launch(p, B * H, static_cast<cudaStream_t>(stream)));
}
