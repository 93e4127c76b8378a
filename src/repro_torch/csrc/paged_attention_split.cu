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
// shrinks below the bytes.  The body is split_decode.cuh's, shared with the
// dense decode kernel; this file gives it the pages.  The design:
//   * Split.  The grid is (C, B * Hkv) with clusters of (C, 1, 1),
//     C = min(max_pages, 8) (8 is the portable cluster size): block r of a
//     cluster takes logical pages r, r + C, r + 2C, ... of its (sequence,
//     kv head).  At TinyLlama's decode (B 8, Hkv 4, 8 table columns) that
//     is 256 blocks on 132 SMs, where one block per (sequence, kv head)
//     gave 32.  The block's physical pages are staged in shared memory
//     first; a warp step's rows are contiguous positions of one page (hence
//     page % 16 == 0), so the page is looked up once a step.
//   * The warps' rings, the products on the tensor cores (bf16) or CUDA
//     cores (fp32) and the combine through distributed shared memory, in
//     the same launch: split_decode.cuh.
// Measured choices (chip_smoke.py at a 32768-position context, B 8, G 8,
// D 64, bf16, on an H100 80GB HBM3 at 700 W; PERF.md, section 6): clusters
// of 1, 2, 4 and 8 blocks took 0.3727, 0.1943, 0.1317 and 0.1036 ms, and
// rings of 1, 2, 3, 4 and 8 steps at C = 8 took 0.1204, 0.1036, 0.1139,
// 0.1179 and 0.1415 ms; so C = min(max_pages, 8) here and kStages = 2 in
// split_decode.cuh.
//
// Layouts (all contiguous):
//   q (B, Hq, D), k_pages/v_pages (P, page, Hkv, D), block_table (B, max_pages)
//   int32, seq_lens (B,) int32, out (B, Hq, D).  Hq = Hkv * G.

#include "split_decode.cuh"

namespace {

using namespace split_decode;

// A block's row `base` in the pool: its page through the block's staged
// physical page ids, then the row in that page.
struct PagedRows {
  const int* ids;          // the block's physical pages, in shared memory
  int page;
  __device__ size_t operator()(int base) const {
    return (size_t)ids[base / page] * page + base % page;
  }
};

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
  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y / Hkv;
  int* ids = reinterpret_cast<int*>(smem + region_bytes<D, G>());

  // This block's pages: logical r, r + C, ... below the pages in use; the
  // last logical page of the sequence may be partial.
  const int len = min(max(seq_lens[b], 0), max_pages * page);
  const Share share = block_share(len, page, rank, C);
  const int* table = block_table + (size_t)b * max_pages;
  for (int k = threadIdx.x; k < share.units; k += kThreads) ids[k] = table[rank + k * C];
  __syncthreads();                             // ids

  decode_block<T, D, G>(q, k_pages, v_pages, out, PagedRows{ids, page}, share.rows,
                        Hkv, scale_log2, smem);
}

}  // namespace

// Once per process and device, before the first launch: lets every
// instance use up to the device's opt-in shared memory per block.  Returns
// a cudaError_t.
extern "C" int paged_attention_split_setup() {
  int limit = 0;
  cudaError_t err = smem_optin(&limit);
  if (err == cudaSuccess)
    err = every_instance([&](auto t, auto d, auto g) {
      using T = std::remove_pointer_t<decltype(t)>;
      return cudaFuncSetAttribute(
          paged_attention_split_kernel<T, decltype(d)::value, decltype(g)::value>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    });
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
  const int C = max_pages < 1 ? 1 : (max_pages < kMaxCluster ? max_pages : kMaxCluster);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
  cudaError_t err = instance(is_bf16, D, Hq / Hkv, [&](auto t, auto d, auto g) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int Dc = decltype(d)::value, Gc = decltype(g)::value;
    const size_t smem = region_bytes<Dc, Gc>() + sizeof(int) * (size_t)((max_pages + C - 1) / C);
    return launch_cluster(
        paged_attention_split_kernel<T, Dc, Gc>, C, B * Hkv, smem,
        static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
        static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        static_cast<const int*>(block_table), static_cast<const int*>(seq_lens),
        static_cast<T*>(out), Hkv, page, max_pages, scale_log2);
  });
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
