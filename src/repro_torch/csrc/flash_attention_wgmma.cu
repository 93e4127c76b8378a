// Forward GQA flash attention in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attention/kernel.py:96, pallas_call at :142) for
// bf16 inputs; fp32 inputs take the CUDA-core kernel in flash_attention.cu.
// Same semantics as both: scale D**-0.5 (or the caller's), causal masking
// at q_offset, an optional sliding window (keys with kpos > qpos - window),
// fp32 running max, sum and accumulator with the finite mask value -1e30 in
// both the fill and the running-max start, key tiles wholly above the
// diagonal or left of the window skipped, ragged Sq and Sk (keys past Sk are
// masked, queries past Sq are not written), any G = Hq / Hkv, D 32, 64,
// 128 or 320.
//
// Bound: at TinyLlama's prefill shape (B 8, S 512, Hq 32, Hkv 4, D 64,
// causal) the call moves 37.7 MB (q, k, v read once, out written once:
// 0.0113 ms at 3.35 TB/s) and does 8.6 GFLOP over the causal pairs (0.0087
// ms at 989 TFLOP/s bf16), so bytes and operations bind it almost equally;
// at G = 1 the bytes double.  fp32 CUDA cores (67 TFLOP/s) could not come
// within 10x of either, so both products run on the tensor cores:
//   * S = Q K^T is wgmma m64n64k16 with Q and K both read from shared memory
//     (K-major: D is contiguous in both, no transpose);
//   * the online softmax runs in fp32 on S's accumulator fragment, each row
//     reduced across the four threads that hold it;
//   * O += P V is wgmma m64nDk16 with P converted to bf16 in registers (the
//     accumulator layout is the A-fragment layout, so no shuffle) and V read
//     MN-major from shared memory (the transpose bit).
// Loads cost no thread instructions: one producer warp issues TMA copies of
// the Q tile and of a two-stage ring of K/V tiles, each stage with a "full"
// and an "empty" mbarrier, while the consumer warpgroup computes on the
// other stage.  TMA's zero fill past a tensor's end covers ragged Sq and Sk.
// The swizzle of each TMA box (128 bytes for a 64-column row, 64 bytes at
// D 32; D 128 loads two 64-column boxes) is the swizzle the wgmma
// descriptors name.  The output goes through a padded shared-memory tile so
// that each row is stored as 16-byte pieces; that tile lies over the K
// stages, which no wgmma reads once the last tile is consumed.
//
// D 320 (gemma3_4b: d_model 2560 over 8 heads) loads five 64-column boxes a
// row, and no single wgmma shape spans 320 columns, so O += P V is five
// m64n64k16 products a key step, one per column block of V, each into its
// own 32 of the 160 accumulator registers a thread holds.  Shared memory
// is 200 KiB (Q 40, two stages of K and V 160), so one block fits an SM and
// the launch bounds let a thread keep O, S and P (208 floats) in registers.
//
// Layout choice: one block per (batch, query head, 64-row query tile), not
// the G heads of a kv head stacked into a tile's rows as the CUDA-core
// kernel does.  One position per row keeps the mask a compare, needs no
// padding rows at G = 3, and makes every G the same code.  The G blocks of
// one kv head are adjacent in launch order, so after the first of them
// reads a K/V tile from device memory the others find it in L2.  Query
// tiles are launched longest first (the causal frontier makes the last
// tile of a sequence the longest).
//
// For the backward (flash_attention_bwd_wgmma.cu) a launch may also write
// each row's log-sum-exp, fp32 in natural-log units, from the running max
// and the reduced sum the epilogue already holds; the pointer is null on
// every other launch (prefill, decode and their CUDA graphs), and the
// output is the same either way.
//
// Layouts (all contiguous, 16-byte aligned): q (B, Sq, Hq, D), k/v
// (B, Sk, Hkv, D), out (B, Sq, Hq, D), Hq = Hkv * G; lse (B, Hq, Sq).

#include "flash_wgmma.cuh"

namespace {

using namespace repro::sm90;
using namespace repro::flash;
using repro::kNegInf;

constexpr int kStages = 2;                // K/V tiles in flight
constexpr int kConsumers = 128;           // one warpgroup computes
constexpr int kThreads = kConsumers + 32; // and one warp loads

// Every tile is a multiple of 1024 bytes, so each starts on a swizzle atom.
// The epilogue stages the output tile (kBM rows of kOStride) in k.
template <int D>
struct __align__(1024) Smem {
  bf16 q[kBM * D];
  bf16 k[kStages][kBN * D];
  bf16 v[kStages][kBN * D];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 320 ? 1 : D == 128 ? 2 : 3)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             bf16* __restrict__ out, float* __restrict__ lse, int Sq,
                             int Sk, int Hq, int G, int causal, int window, int q_offset,
                             float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const KeyRange kr = key_range(q0, Sq, Sk, causal, window, q_offset);
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
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(&sm.q_full, kBM * D * 2);
      for (int c = 0; c < T::kBlocks; ++c)
        tma_load_4d(sm.q + c * kBM * T::kCols, &q_map, &sm.q_full, c * T::kCols, h, q0, b);
      for (int i = 0; i < kr.n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kBN * D * 2);
        const int k0 = kr.lo + i * kBN;
        for (int c = 0; c < T::kBlocks; ++c) {
          tma_load_4d(sm.k[st] + c * kBN * T::kCols, &k_map, &sm.full[st], c * T::kCols,
                      kvh, k0, b);
          tma_load_4d(sm.v[st] + c * kBN * T::kCols, &v_map, &sm.full[st], c * T::kCols,
                      kvh, k0, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  In the m64nN accumulator layout thread (warp,
  // lane) holds rows 16 warp + lane / 4 (+ 8) and, for each 8-column group
  // j, columns 8 j + 2 (lane % 4) (+ 1): element e of a fragment is row
  // (e >> 1) & 1, column group e >> 2, column e & 1 of the pair.
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int qpos0 = q_offset + q0 + row0;
  const uint32_t q_base = smem_addr(sm.q);

  float o[D / 2], s[kBN / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) s[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share

  mbar_wait(&sm.q_full, 0);
  for (int i = 0; i < kr.n; ++i) {
    const int st = i % kStages;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const uint32_t k_base = smem_addr(sm.k[st]), v_base = smem_addr(sm.v[st]);

    // S = Q K^T, D in steps of 16.
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) reg_fence(s[e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, kmajor_desc<D>(q_base, kBM, kk),
                         kmajor_desc<D>(k_base, kBN, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) reg_fence(s[e]);

    // Online softmax in the log2 domain; the mask only on edge tiles.
    const int k0 = kr.lo + i * kBN;
    const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > q_offset + q0) ||
                      (window > 0 && k0 <= q_offset + q0 + kBM - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int r = (e >> 1) & 1;
      float x = s[e] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (e >> 2) + col0 + (e & 1);
        const int qpos = qpos0 + 8 * r;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) x = kNegInf;
      }
      s[e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t p[kBN / 4];
#pragma unroll
    for (int e = 0; e < kBN / 2; e += 2) {
      const int r = (e >> 1) & 1;
      const float p0 = exp2f(s[e] - m[r]), p1 = exp2f(s[e + 1] - m[r]);
      l[r] += p0 + p1;
      p[e / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V, keys in steps of 16: A fragment kk is p[4 kk .. 4 kk + 3].
#pragma unroll
    for (int e = 0; e < D / 2; ++e) reg_fence(o[e]);
#pragma unroll
    for (int e = 0; e < kBN / 4; ++e) reg_fence(p[e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_rs_wide<D>(o, a, v_base, kBN, kk);  // O += P V
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < D / 2; ++e) reg_fence(o[e]);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

  // Epilogue: O / (l + 1e-30) in bf16 through shared memory, rows < Sq.
  // The staging tile lies over the K stages: every wgmma that read them has
  // completed (the last P V's wait implies the warpgroup's earlier ones), and
  // the producer issued no load past the last tile.
  static_assert(sizeof(Smem<D>::k) >= sizeof(bf16) * kBM * T::kOStride,
                "the output tile must fit over the K stages");
  bf16* const o_s = sm.k[0];
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] + 1e-30f);
  }
  // The row's log-sum-exp in natural-log units, for the backward
  // (FlashAttentionFn.forward's launches alone pass lse); kNegInf for a
  // row that saw no key tile.
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (row < Sq)
        lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : kNegInf;
    }
  }
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = (e >> 1) & 1;
    const int row = row0 + 8 * r, col = 8 * (e >> 2) + col0;
    *reinterpret_cast<uint32_t*>(&o_s[row * T::kOStride + col]) =
        pack_bf16(o[e] * inv[r], o[e + 1] * inv[r]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  for (int idx = tid; idx < kBM * kPieces; idx += kConsumers) {
    const int row = idx / kPieces, c = idx % kPieces;
    if (q0 + row < Sq) {
      const size_t off = ((static_cast<size_t>(b) * Sq + q0 + row) * Hq + h) * D + 8 * c;
      *reinterpret_cast<int4*>(out + off) =
          *reinterpret_cast<const int4*>(&o_s[row * T::kOStride + 8 * c]);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // + alignment slack
}

// Lets the instance for D use its dynamic shared memory: a setting of the
// function, not of a launch, made once before the first launch (never
// inside a stream capture).
template <int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, B, Sq, Hq, D, kBM) || !make_map(&k_map, k, B, Sk, Hkv, D, kBN) ||
      !make_map(&v_map, v, B, Sk, Hkv, D, kBN))
    return cudaErrorInvalidValue;
  const dim3 grid(B * Hq, (Sq + kBM - 1) / kBM);
  flash_attention_wgmma_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), lse, Sq, Sk, Hq, Hq / Hkv, causal,
      window, q_offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Once per process and device, before the first launch: raises each
// instance's dynamic shared-memory limit to what it uses.  Returns a
// cudaError_t.
extern "C" int flash_attention_wgmma_setup() {
  cudaError_t err = allow_smem<32>();
  if (err == cudaSuccess) err = allow_smem<64>();
  if (err == cudaSuccess) err = allow_smem<128>();
  if (err == cudaSuccess) err = allow_smem<320>();
  return static_cast<int>(err);
}

// bf16 q, k, v, out; lse, when not null, the fp32 (B, Hq, Sq) log-sum-exp
// of each row; window <= 0 means no window.  Returns a cudaError_t.  Head
// dims 32, 64, 128 and 320 are compiled; flash_attention_wgmma_setup must
// have run on the current device.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int B, int Sq, int Sk,
                                            int Hq, int Hkv, int D, int causal, int window,
                                            int q_offset, float scale, void* stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                        scale, s);
      break;
    case 64:
      err = launch<64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                        scale, s);
      break;
    case 128:
      err = launch<128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                        scale, s);
      break;
    case 320:
      err = launch<320>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                        scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
