// One-token GQA decode attention over the dense K/V cache, for Hopper
// (sm_90a): each sequence's live positions split over the blocks of a
// thread-block cluster.
//
// Replaces no TPU kernel: the JAX package's dense decode
// (src/repro/models/layers.py::_decode_attend) is plain jnp, and so was the
// port's until this kernel (kernels/decode_attention/ref.py keeps that body
// as the plain version).  That body casts the whole cache to fp32, scores
// every position, live or not, then masks: at StarCoder2-7B's decode (B 32,
// cache 3904, 4 kv heads of 128) 81% of a step's device time.  This kernel
// takes the calls that kernels/decode_attention/kernel.py::route sends it:
// D in {64, 128}, G = Hq / Hkv in 1..9, 16-byte aligned q and caches.
// Same semantics: positions [0, valid) of every sequence, the softmax in
// fp32 over the scaled fp32 scores of bf16 x bf16 (or fp32) products, each
// live K/V row read once for all G query heads of its kv head, no position
// at or past `valid` read; valid == 0 gives zeros (the plain body gives the
// mean of V there; the models never call it so).
//
// Bound: bytes, as paged_attention_split.cu's, whose body this is
// (split_decode.cuh); only the rows' addresses differ.  The cache is cut in
// 16-position units: block r of a cluster of C takes units r, r + C,
// r + 2C, ..., unit u being positions [16 u, 16 u + 16) of row
// (b * S_cache + s) * Hkv + h, and a warp step is one unit (bf16) or half
// of one (fp32).  The grid is (C, B * Hkv), C = min(ceil(S_cache / 16), 8):
// from the cache's shape, so a CUDA graph records it and a replay is right
// at any length.  `valid` is a 0-d int32 on the device, read by every
// block and never by the host; the last unit is masked at it, and no unit
// reads past S_cache.  A window ring needs nothing more: attention does not
// depend on the ring's order, and valid is capped at the ring's size.
//
// Layouts (all contiguous): q (B, Hq, D), k/v (B, S_cache, Hkv, D), valid
// () int32, out (B, Hq, D).

#include "split_decode.cuh"

namespace {

using namespace split_decode;

constexpr int kUnit = 16;              // positions a unit

// A block's row `base` in the cache: unit base / 16 of the block is unit
// (base / 16) * C + rank of the sequence.
struct DenseRows {
  size_t seq0;             // b * S_cache
  int rank, C;
  __device__ size_t operator()(int base) const {
    return seq0 + ((size_t)(base / kUnit) * C + rank) * kUnit + base % kUnit;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ valid,
                              T* __restrict__ out, int Hkv, int S_cache, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y / Hkv;
  const int len = min(max(*valid, 0), S_cache);
  const Share share = block_share(len, kUnit, rank, C);
  decode_block<T, D, G>(q, k, v, out, DenseRows{(size_t)b * S_cache, rank, C}, share.rows,
                        Hkv, scale_log2, smem);
}

}  // namespace

// Once per process and device, before the first launch: lets every
// instance use up to the device's opt-in shared memory per block.  Returns
// a cudaError_t.
extern "C" int decode_attention_split_setup() {
  int limit = 0;
  cudaError_t err = smem_optin(&limit);
  if (err == cudaSuccess)
    err = every_instance([&](auto t, auto d, auto g) {
      using T = std::remove_pointer_t<decltype(t)>;
      return cudaFuncSetAttribute(
          decode_attention_split_kernel<T, decltype(d)::value, decltype(g)::value>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    });
  return static_cast<int>(err);
}

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  Returns a cudaError_t.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out,
    int B, int Hq, int Hkv, int D, int S_cache, float scale, int is_bf16,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv || S_cache < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (S_cache + kUnit - 1) / kUnit;
  const int C = units < kMaxCluster ? units : kMaxCluster;
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
  cudaError_t err = instance(is_bf16, D, Hq / Hkv, [&](auto t, auto d, auto g) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int Dc = decltype(d)::value, Gc = decltype(g)::value;
    return launch_cluster(
        decode_attention_split_kernel<T, Dc, Gc>, C, B * Hkv, region_bytes<Dc, Gc>(),
        static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(valid), static_cast<T*>(out), Hkv, S_cache, scale_log2);
  });
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
