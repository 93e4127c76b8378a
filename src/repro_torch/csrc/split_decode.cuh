// The body of the split decode attention kernels (sm_90a): one query token
// a sequence against its K/V rows, the rows of a (sequence, kv head) split
// over the C blocks of a thread-block cluster and combined in the same
// launch.  Two kernels include it and differ only in how a block finds its
// rows (the `Rows` policy of `decode_block`):
//   * paged_attention_split.cu: rows through a block table of pages;
//   * decode_attention_split.cu: rows of the dense (B, S_cache, Hkv, D)
//     cache, in 16-position units.
//
// The design (measurements in paged_attention_split.cu and PERF.md,
// section 6):
//   * Split.  The grid is (C, B * Hkv) with clusters of (C, 1, 1), C at
//     most 8 (the portable cluster size): block r of a cluster takes units
//     r, r + C, r + 2C, ... of its (sequence, kv head), a unit being a page
//     or 16 positions; `block_share` counts its rows.
//   * 16-byte loads, in flight during compute.  Each of the 4 warps owns a
//     cp.async ring of kStages = 2 steps in shared memory (16 bf16 or 8
//     fp32 rows of K and of V a step, 16 bytes a copy, neighbouring lanes
//     on neighbouring bytes of a row) and issues step s + 1 before
//     computing step s.  Each warp keeps its own online-softmax state
//     (m, l, acc); no block barrier until the combine.  A step's rows are
//     contiguous positions of one unit (hence a unit of a multiple of 16),
//     so a unit is looked up once a step.
//   * bf16: mma.sync m16n8k16 (warp_mma below): the heads are the 16 rows
//     of Q K^T and of P V, the scores scaled in fp32, P split into bf16 hi
//     and lo so its rounding costs about 2^-16.  fp32: CUDA cores
//     (warp_simt), which keep fp32 inputs exact.
//   * Combine in the same launch.  Warps combine through shared memory,
//     then the C blocks of a cluster through distributed shared memory
//     (map_shared_rank): with M = max m_i, l = sum l_i 2^(m_i - M) and
//     acc = sum acc_i 2^(m_i - M), each rank writes a slice of the
//     output, acc / (l + 1e-30), so a sequence with no row gives zeros.  A
//     block with no row contributes m = -1e30, l = 0, acc = 0.  No second
//     kernel, no workspace: the wrapper allocates only the output, and the
//     launch neither allocates nor synchronises.
//
// Layouts (all contiguous): q (B, Hq, D), out (B, Hq, D), Hq = Hkv * G; a
// K/V row of kv head h at row index i of its pool or cache sits at
// (i * Hkv + h) * D.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "mma_sync.cuh"

namespace split_decode {

namespace cg = cooperative_groups;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::kNegInf;
using repro::mma;
using repro::split2;

constexpr int kThreads = 128;          // four warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 9;               // query heads per kv head, at most
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kStages = 2;             // cp.async ring depth of a warp

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned char* p) {
  repro::ldsm_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const unsigned char* p) {
  repro::ldsm_x4_t(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

// Bytes of one warp step in the ring: K then V, 16 bf16 or 8 fp32 rows of
// D each, so 64 * D either way.
template <int D>
constexpr int kStepBytes = 64 * D;

template <typename T>
constexpr int kRows = std::is_same<T, float>::value ? 8 : 16;

// Dynamic shared memory of a block: the warps' rings, aliased after the
// main loop by the combine buffers.  A kernel may keep more after it.
template <int D, int G>
__host__ __device__ constexpr size_t region_bytes() {
  constexpr size_t ring = (size_t)kWarps * kStages * kStepBytes<D>;
  constexpr size_t comb = sizeof(float) * ((size_t)kWarps * G * (D + 2) + (size_t)G * (D + 2));
  return ((ring > comb ? ring : comb) + 15) / 16 * 16;
}

// Rank `rank` of a cluster of C takes units rank, rank + C, ... of the
// `len` rows in use, `unit` rows a unit, the last possibly partial: `units`
// of them, `rows` rows in all.
struct Share {
  int units, rows;
};

__device__ __forceinline__ Share block_share(int len, int unit, int rank, int C) {
  const int used = (len + unit - 1) / unit;
  const int nb = used > rank ? (used - rank + C - 1) / C : 0;
  int total = nb * unit;
  if (nb > 0 && (used - 1) % C == rank) total -= used * unit - len;
  return {nb, total};
}

// What a warp's loop needs: its rows are [base, base + kRows) of the
// block's, base = (s * kWarps + warp) * kRows for its steps s; rows(base)
// is the row index of the block's row `base` in the pool or cache, and the
// step's rows follow it.
template <typename T, typename Rows>
struct Walk {
  const T* k;
  const T* v;
  unsigned char* ring;     // this warp's kStages slots
  Rows rows;
  int total, Hkv, h, warp, lane;

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
template <int D, int G, typename Rows>
__device__ __forceinline__ void warp_simt(const Walk<float, Rows>& w, const float* qb,
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
    const size_t row0 = w.rows(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = u * R + rg;
      const bool ok = base + r < w.total;
      const size_t off = ((row0 + r) * w.Hkv + w.h) * D + j * E;
      cp_async16(slot + (u * 32 + lane) * 16, ok ? w.k + off : w.k, ok);
      cp_async16(slot + ((U + u) * 32 + lane) * 16, ok ? w.v + off : w.v, ok);
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
template <int D, int G, typename Rows>
__device__ __forceinline__ void warp_mma(const Walk<__nv_bfloat16, Rows>& w,
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
    const size_t row0 = w.rows(base);
#pragma unroll
    for (int t = 0; t < KC / 2; ++t) {         // 16 rows x KC chunks
      const int idx = lane + 32 * t, r = idx / KC, c = idx % KC;
      const bool ok = base + r < w.total;
      const size_t off = ((row0 + r) * w.Hkv + w.h) * D + c * 8;
      cp_async16(slot + swz(r, c), ok ? w.k + off : w.k, ok);
      cp_async16(slot + 32 * D + swz(r, c), ok ? w.v + off : w.v, ok);
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

// One block's part of a cluster: its warps walk its `total` rows (found
// through `rows`), combine in shared memory, then the cluster's blocks
// combine through distributed shared memory and each writes a slice of
// the (sequence, kv head)'s G output rows.  Every thread of every block of
// the cluster calls it.
template <typename T, int D, int G, typename Rows>
__device__ __forceinline__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             const Rows& rows, int total, int Hkv,
                                             float scale_log2, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;                     // the cluster: one along x
  const int rank = blockIdx.x;
  const int h = blockIdx.y % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const Walk<T, Rows> w{k, v, smem + (size_t)warp * kStages * kStepBytes<D>,
                        rows, total, Hkv, h, warp, lane};
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
    for (int u = 0; u < kWarps; ++u) {
      mw[u] = wm[u * G + g];
      M = fmaxf(M, mw[u]);
    }
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float f = exp2f(mw[u] - M);
      a = fmaf(wacc[(u * G) * D + i], f, a);
      s = fmaf(wl[u * G + g], f, s);
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

// Launch `kernel` on a grid of (C, blocks) in clusters of (C, 1, 1).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int C, int blocks, size_t smem,
                           cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, blocks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(T*, Int<D>, Int<G>) for the instance G (or, g == 0, every G in
// 1..kMaxG, stopping at the first error).
template <typename T, int D, int G = 1, typename F>
cudaError_t each_g(int g, F& f) {
  if constexpr (G > kMaxG) {
    return g == 0 ? cudaSuccess : cudaErrorInvalidValue;
  } else {
    if (g == 0 || g == G) {
      const cudaError_t err = f(static_cast<T*>(nullptr), Int<D>{}, Int<G>{});
      if (err != cudaSuccess || g == G) return err;
    }
    return each_g<T, D, G + 1>(g, f);
  }
}

// f(T*, Int<D>, Int<G>) for the compiled instance that (is_bf16, D, G)
// names, or cudaErrorInvalidValue if there is none.
template <typename F>
cudaError_t instance(int is_bf16, int D, int G, F&& f) {
  if (G < 1) return cudaErrorInvalidValue;
  if (D == 64) return is_bf16 ? each_g<__nv_bfloat16, 64>(G, f) : each_g<float, 64>(G, f);
  if (D == 128) return is_bf16 ? each_g<__nv_bfloat16, 128>(G, f) : each_g<float, 128>(G, f);
  return cudaErrorInvalidValue;
}

// f for every compiled instance, stopping at the first error.
template <typename F>
cudaError_t every_instance(F&& f) {
  cudaError_t err = each_g<__nv_bfloat16, 64>(0, f);
  if (err == cudaSuccess) err = each_g<__nv_bfloat16, 128>(0, f);
  if (err == cudaSuccess) err = each_g<float, 64>(0, f);
  if (err == cudaSuccess) err = each_g<float, 128>(0, f);
  return err;
}

// The device's opt-in shared memory per block, for every instance's
// cudaFuncSetAttribute.
inline cudaError_t smem_optin(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

}  // namespace split_decode
