// Pieces shared by the bf16 flash kernels on Hopper's tensor cores, the
// forward (flash_attention_wgmma.cu) and its backward
// (flash_attention_bwd_wgmma.cu): the swizzled geometry of a tile of
// head-dim rows, the wgmma descriptors of such tiles read K-major and
// MN-major, bf16 packing, the key tiles a query tile sees, and the TMA map
// of a (B, S, H, D) bf16 tensor.
#pragma once

#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // query rows of a tile: one wgmma M tile
constexpr int kBN = 64;   // keys of a K/V tile

// A tile of rows of D bf16 columns as TMA writes it: 64-column blocks (all
// D at D 32), each row of a block one swizzled 128-byte (64-byte) line.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;   // columns of a TMA box and a swizzled row
  static constexpr int kRowBytes = 2 * kCols;     // 64 or 128
  static constexpr int kBlocks = D / kCols;       // column blocks: 2 at D 128
  static constexpr int kAtom = 8 * kRowBytes;     // one swizzle atom: 8 rows
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor code
  static constexpr int kOStride = D + 8;          // padded output row: no bank conflicts
};

// Descriptor of columns [16 kk, 16 kk + 16) of a tile of `rows` rows read
// K-major (the head dim is the product's depth): the start moves within the
// swizzled row, or to the next column block at D 128 and 320; the stride
// byte offset steps over 8-row atoms.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int rows, int kk) {
  using T = Tile<D>;
  const int col = 16 * kk;
  return sm90::smem_desc(base + (col / T::kCols) * rows * T::kRowBytes + (col % T::kCols) * 2,
                         16, T::kAtom, T::kSwizzle);
}

// Descriptor of rows [16 kk, 16 kk + 16) of a tile of `rows` rows read
// MN-major (the rows are the product's depth, D contiguous): the leading
// byte offset steps between 64-column blocks.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int rows, int kk) {
  using T = Tile<D>;
  return sm90::smem_desc(base + 16 * kk * T::kRowBytes, rows * T::kRowBytes, T::kAtom,
                         T::kSwizzle);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Key tiles of `bn` keys any row of the query tile at q0 can see:
// [lo, lo + n * bn).
struct KeyRange {
  int lo, n;
};

__device__ __forceinline__ KeyRange key_range(int q0, int Sq, int Sk, int causal,
                                              int window, int q_offset, int bn = kBN) {
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBM, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q_first - window + 1) / bn * bn : 0;
  return {lo, hi > lo ? (hi - lo + bn - 1) / bn : 0};
}

// d (64 x D, fp32) += a (64 x 16, bf16 pairs in registers) * rows
// [16 kk, 16 kk + 16) of a tile of `rows` rows of D columns read MN-major:
// one wgmma of N = D up to D 128; at D 320, which no wgmma shape spans, one
// m64n64 per 64-column block c into d[32 c, 32 c + 32) (so d[e] is column
// 8 (e >> 2) + 2 (lane % 4) + (e & 1) at every D).
template <int D>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint32_t base, int rows, int kk) {
  if constexpr (D <= 128) {
    sm90::wgmma_rs<D>(d, a, mnmajor_desc<D>(base, rows, kk));
  } else {
    using T = Tile<D>;
#pragma unroll
    for (int c = 0; c < T::kBlocks; ++c)
      sm90::wgmma_rs_m64n64k16(*reinterpret_cast<float(*)[32]>(d + 32 * c), a,
                               mnmajor_desc<D>(base + c * rows * T::kRowBytes, rows, kk));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded; these libraries link only against the runtime.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A (B, S, H, D) bf16 tensor as a 4-D TMA map, innermost first (D, H, S, B),
// whose box is `rows` positions of one head by 64 columns (all D at D 32).
// The maps are encoded on the host at each launch and passed by value as
// __grid_constant__ parameters, so a CUDA graph that captures a launch
// keeps the maps, and with them the addresses of the tensors at the
// capture.  That is right only because a captured decode step is replayed
// on the tensors it was captured on (serve/engine.py::DecodeGraph refuses
// any other); a replay on new tensors would read the old ones.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                     int rows) {
  const int cols = D < 64 ? D : 64;
  const cuuint64_t s = S > 0 ? S : 1;  // no load is issued when S is 0
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), s, cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2, s * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
}  // namespace repro
