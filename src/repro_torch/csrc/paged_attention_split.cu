// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a):
// each sequence's pages split over the blocks of a thread-block cluster.
//
// Replaces paged_attention_pallas / _pa_kernel (src/repro/kernels/
// paged_attention/kernel.py:84, pallas_call at :117) on the calls the
// models make: D in {64, 128}, G = Hq / Hkv in 1..9, page a multiple of 16,
// 16-byte aligned q and pools; paged_attention.cu takes every other call,
// by the rule in kernels/paged_attention/kernel.py::route.  Same semantics:
// the block table translates (sequence, logical page) -> physical pool page
// before each read, pages past ceil(seq_len / page) are never touched (nor
// their table entries), the softmax runs online in fp32, and the output is
// acc / (l + 1e-30), so seq_len == 0 gives zeros.
//
// Bound: bytes.  Decode reads each valid K/V row once and does 4*G*D flops
// per row (G query heads share it), far below the ~295 flops/byte at which
// the tensor cores bind.  But on CUDA cores the same work is G flops a byte
// of bf16 rows, 8 at TinyLlama's G = 8, against their 20 (67 TFLOP/s over
// 3.35 TB/s), and every row also costs the shuffles of its dot product and
// G exponentials: a first version of this kernel with fp32 FMAs on CUDA
// cores for bf16 too took 0.2881 ms at a 32768-position context, 4.1x the
// bytes bound, and did not get faster with a deeper ring (chip_smoke.py on
// an H100 80GB HBM3 at 700 W; PERF.md, section 6).  So bf16 calls run
// their two products on the tensor cores, and the instruction stream
// shrinks below the bytes.  The design:
//   * Split.  The grid is (C, B * Hkv) with clusters of (C, 1, 1),
//     C = min(max_pages, 8) (8 is the portable cluster size): block r of a
//     cluster takes logical pages r, r + C, r + 2C, ... of its (sequence,
//     kv head).  At TinyLlama's decode (B 8, Hkv 4, 8 table columns) that
//     is 256 blocks on 132 SMs, where one block per (sequence, kv head)
//     gave 32.  The block's physical pages are staged in shared memory
//     first; a warp step's rows are contiguous positions of one page (hence
//     page % 16 == 0), so the page is looked up once a step.
//   * 16-byte loads, in flight during compute.  Each of the 4 warps owns a
//     cp.async ring of kStages = 2 steps in shared memory (16 bf16 or 8
//     fp32 rows of K and of V a step, 16 bytes a copy, neighbouring lanes
//     on neighbouring bytes of a row) and issues step s + 1 before
//     computing step s.  Each warp keeps its own online-softmax state
//     (m, l, acc); no block barrier until the combine.
//   * bf16: mma.sync m16n8k16 (warp_mma below): the heads are the 16 rows
//     of Q K^T and of P V, the scores scaled in fp32, P split into bf16 hi
//     and lo so its rounding costs about 2^-16.  fp32: CUDA cores
//     (warp_simt), which keep fp32 inputs exact.
//   * Combine in the same launch.  Warps combine through shared memory,
//     then the C blocks of a cluster through distributed shared memory
//     (map_shared_rank): with M = max m_i, l = sum l_i 2^(m_i - M) and
//     acc = sum acc_i 2^(m_i - M), each rank writes a slice of the
//     output.  A block with no page contributes m = -1e30, l = 0, acc = 0.
//     No second kernel, no workspace: the wrapper allocates only the
//     output, and the launch neither allocates nor synchronises.
// Measured choices (chip_smoke.py at a 32768-position context, B 8, G 8,
// D 64, bf16, on an H100 80GB HBM3 at 700 W; PERF.md, section 6): clusters
// of 1, 2, 4 and 8 blocks took 0.3727, 0.1943, 0.1317 and 0.1036 ms, and
// rings of 1, 2, 3, 4 and 8 steps at C = 8 took 0.1204, 0.1036, 0.1139,
// 0.1179 and 0.1415 ms; so C = min(max_pages, 8) and kStages = 2, both
// fixed here.
//
// Layouts (all contiguous):
//   q (B, Hq, D), k_pages/v_pages (P, page, Hkv, D), block_table (B, max_pages)
//   int32, seq_lens (B,) int32, out (B, Hq, D).  Hq = Hkv * G.

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kNegInf;

constexpr int kThreads = 128;          // four warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 9;               // query heads per kv head, at most
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kStages = 2;             // cp.async ring depth of a warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, cached in L2 only; with
// valid == false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The 16 bytes of a lane as 4 fp32.
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// ldmatrix: four 8 x 8 bf16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8 (the second form transposes each on the way).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the low
// half, as the MMA fragments order their pairs.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Bytes of one warp step in the ring: K then V, 16 bf16 or 8 fp32 rows of
// D each, so 64 * D either way.
template <int D>
constexpr int kStepBytes = 64 * D;

template <typename T>
constexpr int kRows = std::is_same<T, float>::value ? 8 : 16;

// Dynamic shared memory: the warps' rings, aliased after the main loop by
// the combine buffers, then the block's physical page ids.
template <int D, int G>
__host__ __device__ constexpr size_t region_bytes() {
  constexpr size_t ring = (size_t)kWarps * kStages * kStepBytes<D>;
  constexpr size_t comb = sizeof(float) * ((size_t)kWarps * G * (D + 2) + (size_t)G * (D + 2));
  return ((ring > comb ? ring : comb) + 15) / 16 * 16;
}

// What a warp's loop needs: its rows are [base, base + kRows) of the
// block's, base = (s * kWarps + warp) * kRows for its steps s.
template <typename T>
struct Walk {
  const T* k_pages;
  const T* v_pages;
  unsigned char* ring;     // this warp's kStages slots
  const int* ids;          // the block's physical pages
  int total, page, Hkv, h, warp, lane;

  __device__ int steps() const {
    constexpr int R = kRows<T>;
    return total > warp * R ? (total - warp * R + kWarps * R - 1) / (kWarps * R) : 0;
  }
  __device__ int base(int s) const { return (s * kWarps + warp) * kRows<T>; }
};

// The warp's partial softmax (m, l and acc of each of its heads) into the
// combine buffers: wm, wl [kWarps][G] and wacc [kWarps][G][D].
struct Partials {
  float* wm;
  float* wl;
  float* wacc;
};

// fp32: CUDA cores.  A lane copies 16 bytes (4 values) of a row: L = D / 4
// lanes cover it and a warp load takes R = 32 / L rows; a step's 8 rows
// are U = 8 / R loads a lane.  q sits in registers scaled by
// scale * log2(e); each row's dot product is reduced over its L lanes with
// __shfl_xor_sync; the warp's running max is shared by all its lanes.
template <int D, int G>
__device__ __forceinline__ void warp_simt(const Walk<float>& w, const float* qb,
                                          float scale_log2, const Partials& out) {
  constexpr int E = 4, L = D / E, R = 32 / L, U = 8 / R;
  static_assert(L <= 32 && 32 % L == 0 && 8 % R == 0, "bad geometry");
  const int lane = w.lane, rg = lane / L, j = lane % L;
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack(*reinterpret_cast<const uint4*>(qb + (size_t)g * D + j * E), qr[g]);
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] *= scale_log2;
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  // Slot layout: K then V, each [U][32 lanes][16 bytes]; a lane reads back
  // only what it copied, so the ring needs no barrier.
  const int nsteps = w.steps();
  auto issue = [&](int s) {
    unsigned char* slot = w.ring + (size_t)(s % kStages) * kStepBytes<D>;
    const int base = w.base(s);
    const size_t row0 = (size_t)w.ids[base / w.page] * w.page + base % w.page;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = u * R + rg;
      const bool ok = base + r < w.total;
      const size_t off = ((row0 + r) * w.Hkv + w.h) * D + j * E;
      cp_async16(slot + (u * 32 + lane) * 16, ok ? w.k_pages + off : w.k_pages, ok);
      cp_async16(slot + ((U + u) * 32 + lane) * 16, ok ? w.v_pages + off : w.v_pages, ok);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();              // step s has landed
    const unsigned char* slot = w.ring + (size_t)(s % kStages) * kStepBytes<D>;
    const int base = w.base(s);
    float sc[U][G];                            // scores, log2 units
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[E];
      unpack(*reinterpret_cast<const uint4*>(slot + (u * 32 + lane) * 16), kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qr[g][e], kx[e], a);
        sc[u][g] = a;
      }
    }
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {          // over the row's lanes
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * R + rg >= w.total) {      // past the sequence
#pragma unroll
        for (int g = 0; g < G; ++g) sc[u][g] = kNegInf;
      }
    }
    // The warp's running max; the step's first row is always valid.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx > m[g]) {                         // warp-uniform
        const float alpha = exp2f(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        m[g] = mx;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[E];
      unpack(*reinterpret_cast<const uint4*>(slot + ((U + u) * 32 + lane) * 16), vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = exp2f(sc[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {          // sum over the row groups
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  __syncthreads();                             // every ring is drained
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        out.wm[w.warp * G + g] = m[g];
        out.wl[w.warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) out.wacc[(w.warp * G + g) * D + j * E + e] = acc[g][e];
    }
  }
}

// bf16: tensor cores, mma.sync m16n8k16 with fp32 accumulation.  A step is
// 16 rows; K and V land in the ring as [16][D] bf16 tiles whose 16-byte
// chunks are swizzled (chunk c of row r at c ^ (r % 8)), so ldmatrix reads
// them without bank conflicts.  The heads are the M = 16 rows of the
// products (rows G..15 are zero): S = Q K^T over the step's two 8-row
// n-tiles, scaled by scale * log2(e) in fp32, then P V with P split into
// bf16 hi and lo (two MMAs each), so P's rounding costs about 2^-16, not
// 2^-9.  Lane (gq, tq) = (lane / 4, lane % 4) holds heads gq and gq + 8:
// their running max is shared by a quad of lanes, and a rescale touches
// only the lane's own accumulator rows.
template <int D, int G>
__device__ __forceinline__ void warp_mma(const Walk<__nv_bfloat16>& w,
                                         const __nv_bfloat16* qb, float scale_log2,
                                         const Partials& out) {
  constexpr int KC = D / 8;                    // 16-byte chunks of a row
  constexpr int KS = D / 16;                   // k-steps of Q K^T
  constexpr int NT = D / 8;                    // 8-column tiles of P V
  const int lane = w.lane, gq = lane / 4, tq = lane % 4;
  // Q as A fragments: {(gq, k), (gq + 8, k), (gq, k + 8), (gq + 8, k + 8)},
  // k = 16 ks + 2 tq.
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = gq + 8 * (i & 1), k = 16 * ks + 8 * (i >> 1) + 2 * tq;
      qa[ks][i] = g < G ? *reinterpret_cast<const uint32_t*>(qb + (size_t)g * D + k) : 0u;
    }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads gq, gq + 8

  const int nsteps = w.steps();
  auto swz = [](int r, int c) { return r * (2 * D) + ((c ^ (r & 7)) << 4); };
  auto issue = [&](int s) {
    unsigned char* slot = w.ring + (size_t)(s % kStages) * kStepBytes<D>;
    const int base = w.base(s);
    const size_t row0 = (size_t)w.ids[base / w.page] * w.page + base % w.page;
#pragma unroll
    for (int t = 0; t < KC / 2; ++t) {         // 16 rows x KC chunks
      const int idx = lane + 32 * t, r = idx / KC, c = idx % KC;
      const bool ok = base + r < w.total;
      const size_t off = ((row0 + r) * w.Hkv + w.h) * D + c * 8;
      cp_async16(slot + swz(r, c), ok ? w.k_pages + off : w.k_pages, ok);
      cp_async16(slot + 32 * D + swz(r, c), ok ? w.v_pages + off : w.v_pages, ok);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  const int mi = lane / 8, mr = lane % 8;      // ldmatrix: matrix, row
  for (int s = 0; s < nsteps; ++s) {
    __syncwarp();                              // the slot refilled below is read
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();                              // step s, every lane's copies
    const unsigned char* kt = w.ring + (size_t)(s % kStages) * kStepBytes<D>;
    const unsigned char* vt = kt + 32 * D;
    const int base = w.base(s);

    float sc[2][4] = {};                       // n-tile, C fragment
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];                           // (n-tile 0, k lo/hi), (1, lo/hi)
      ldsm_x4(b, kt + swz((mi >> 1) * 8 + mr, 2 * ks + (mi & 1)));
      mma(sc[0], qa[ks], b[0], b[1]);
      mma(sc[1], qa[ks], b[2], b[3]);
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = base + 8 * n + 2 * tq + (i & 1) < w.total;
        const float x = ok ? sc[n][i] * scale_log2 : kNegInf;
        sc[n][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {          // over the quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // The step's first row is always valid, so the new max is finite.
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(sc[n][i] - (i < 2 ? m0 : m1));
        sc[n][i] = p;
        if (i < 2) l0 += p; else l1 += p;
      }
    // P (heads x 16 rows) as an A fragment: the C fragments of the two
    // n-tiles are its k halves.
    uint32_t ph[4], pl[4];
    split2(sc[0][0], sc[0][1], ph[0], pl[0]);
    split2(sc[0][2], sc[0][3], ph[1], pl[1]);
    split2(sc[1][0], sc[1][1], ph[2], pl[2]);
    split2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];                           // (rows 0-7, 8-15) x tiles n, n + 1
      ldsm_x4_t(b, vt + swz((mi & 1) * 8 + mr, n + (mi >> 1)));
      mma(acc[n], ph, b[0], b[1]);
      mma(acc[n], pl, b[0], b[1]);
      mma(acc[n + 1], ph, b[2], b[3]);
      mma(acc[n + 1], pl, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncthreads();                             // every ring is drained
  const int g1 = gq + 8;
  if (tq == 0 && gq < G) {
    out.wm[w.warp * G + gq] = m0;
    out.wl[w.warp * G + gq] = l0;
  }
  if (tq == 0 && g1 < G) {
    out.wm[w.warp * G + g1] = m1;
    out.wl[w.warp * G + g1] = l1;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = 8 * n + 2 * tq;
    if (gq < G) {
      out.wacc[(w.warp * G + gq) * D + d] = acc[n][0];
      out.wacc[(w.warp * G + gq) * D + d + 1] = acc[n][1];
    }
    if (g1 < G) {
      out.wacc[(w.warp * G + g1) * D + d] = acc[n][2];
      out.wacc[(w.warp * G + g1) * D + d + 1] = acc[n][3];
    }
  }
}

// The register budget asks for one block an SM, so ptxas takes what each
// instance needs (at most 230 registers, no spills): left to its own
// choices it capped some instances lower and spilled 4 bytes in them.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ block_table,
                             const int* __restrict__ seq_lens, T* __restrict__ out,
                             int Hkv, int page, int max_pages, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;                     // the cluster: one along x
  const int rank = blockIdx.x;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* ids = reinterpret_cast<int*>(smem + region_bytes<D, G>());

  // This block's pages: logical r, r + C, ... below `used`; the last logical
  // page of the sequence may be partial.
  const int len = min(max(seq_lens[b], 0), max_pages * page);
  const int used = (len + page - 1) / page;
  const int nb = used > rank ? (used - rank + C - 1) / C : 0;
  const int* table = block_table + (size_t)b * max_pages;
  for (int k = tid; k < nb; k += kThreads) ids[k] = table[rank + k * C];
  int total = nb * page;                       // rows of this block
  if (nb > 0 && (used - 1) % C == rank) total -= used * page - len;
  __syncthreads();                             // ids

  const Walk<T> w{k_pages, v_pages, smem + (size_t)warp * kStages * kStepBytes<D>,
                  ids, total, page, Hkv, h, warp, lane};
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* wl = wm + kWarps * G;                 // [kWarps][G]
  float* wacc = wl + kWarps * G;               // [kWarps][G][D]
  float* bm = wacc + kWarps * G * D;           // [G]     the block's, read
  float* bl = bm + G;                          // [G]     by the cluster
  float* bacc = bl + G;                        // [G][D]
  const T* qb = q + ((size_t)blockIdx.y * G) * D;
  if constexpr (std::is_same<T, float>::value) {
    warp_simt<D, G>(w, qb, scale_log2, Partials{wm, wl, wacc});
  } else {
    warp_mma<D, G>(w, qb, scale_log2, Partials{wm, wl, wacc});
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mw[kWarps], M = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      mw[v] = wm[v * G + g];
      M = fmaxf(M, mw[v]);
    }
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float f = exp2f(mw[v] - M);
      a = fmaf(wacc[(v * G) * D + i], f, a);
      s = fmaf(wl[v * G + g], f, s);
    }
    bacc[i] = a;
    if (i % D == 0) {
      bm[g] = M;
      bl[g] = s;
    }
  }
  cluster.sync();                              // every block's partial is ready

  // Rank r writes elements r * kThreads + tid, stepping by C * kThreads.
  T* ob = out + ((size_t)blockIdx.y * G) * D;
  for (int i = rank * kThreads + tid; i < G * D; i += C * kThreads) {
    const int g = i / D;
    float rm[kMaxCluster], rl[kMaxCluster], ra[kMaxCluster], M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        rm[r] = *cluster.map_shared_rank(bm + g, r);
        rl[r] = *cluster.map_shared_rank(bl + g, r);
        ra[r] = *cluster.map_shared_rank(bacc + i, r);
        M = fmaxf(M, rm[r]);
      }
    }
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float f = exp2f(rm[r] - M);
        a = fmaf(ra[r], f, a);
        s = fmaf(rl[r], f, s);
      }
    }
    ob[i] = repro::from_float<T>(a / (s + 1e-30f));
  }
  cluster.sync();                              // keep shared memory alive
}

struct Args {
  const void *q, *k_pages, *v_pages, *block_table, *seq_lens;
  void* out;
  int B, Hkv, page, max_pages, cluster;
  float scale_log2;
};

template <typename T, int D, int G>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  const size_t smem = region_bytes<D, G>()
      + sizeof(int) * (size_t)((a.max_pages + a.cluster - 1) / a.cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.B * a.Hkv, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, paged_attention_split_kernel<T, D, G>, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_pages), static_cast<const T*>(a.v_pages),
      static_cast<const int*>(a.block_table), static_cast<const int*>(a.seq_lens),
      static_cast<T*>(a.out), a.Hkv, a.page, a.max_pages, a.scale_log2);
}

// Launch the instance for G, or (a == nullptr) raise every instance's
// dynamic shared-memory limit to `smem_limit` bytes.
template <typename T, int D, int G = 1>
cudaError_t for_g(int g, const Args* a, cudaStream_t stream, int smem_limit) {
  if constexpr (G > kMaxG) {
    return a ? cudaErrorInvalidValue : cudaSuccess;
  } else {
    if (!a) {
      cudaError_t err = cudaFuncSetAttribute(
          paged_attention_split_kernel<T, D, G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
      if (err != cudaSuccess) return err;
    } else if (g == G) {
      return launch_one<T, D, G>(*a, stream);
    }
    return for_g<T, D, G + 1>(g, a, stream, smem_limit);
  }
}

template <typename T>
cudaError_t for_d(int D, int G, const Args* a, cudaStream_t stream, int smem_limit) {
  if (!a) {
    cudaError_t err = for_g<T, 64>(G, a, stream, smem_limit);
    return err != cudaSuccess ? err : for_g<T, 128>(G, a, stream, smem_limit);
  }
  if (D == 64) return for_g<T, 64>(G, a, stream, smem_limit);
  if (D == 128) return for_g<T, 128>(G, a, stream, smem_limit);
  return cudaErrorInvalidValue;
}

}  // namespace

// Once per process and device, before the first launch: lets every
// instance use up to the device's opt-in shared memory per block.  Returns
// a cudaError_t.
extern "C" int paged_attention_split_setup() {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = for_d<__nv_bfloat16>(0, 0, nullptr, nullptr, limit);
  if (err == cudaSuccess) err = for_d<float>(0, 0, nullptr, nullptr, limit);
  return static_cast<int>(err);
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  The cluster size is
// min(max_pages, 8), at least 1: from the table's shape, never from
// seq_lens, which the host does not read.  Returns a cudaError_t.
extern "C" int paged_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, void* out, int B, int Hq,
    int Hkv, int D, int page, int max_pages, float scale, int is_bf16,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv || page % 16 || max_pages < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cluster = max_pages < 1 ? 1 : (max_pages < kMaxCluster ? max_pages : kMaxCluster);
  const Args a{q, k_pages, v_pages, block_table, seq_lens, out, B, Hkv,
               page, max_pages, cluster,
               scale * 1.4426950408889634f};   // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? for_d<__nv_bfloat16>(D, Hq / Hkv, &a, s, 0)
                            : for_d<float>(D, Hq / Hkv, &a, s, 0);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
