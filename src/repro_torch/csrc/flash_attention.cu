// Forward GQA flash attention for Hopper (sm_90a).
//
// Replaces flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attention/kernel.py).  Same semantics: scale
// D**-0.5 (or the caller's), causal masking at q_offset, an optional sliding
// window (keys with kpos > qpos - window), fp32 online softmax with the finite
// mask value -1e30 in both the fill and the running-max start, and key tiles
// wholly above the diagonal or left of the window skipped.  Unlike the Pallas
// kernel it takes ragged Sq and Sk: keys past Sk are masked and queries past
// Sq are not written.
//
// Bound: at prefill shapes (S 512, D 64, bf16) the bytes of q, k, v and out
// bind an H100 slightly before the causal flops at the tensor cores' bf16
// rate do (chip_smoke.py computes both).  This first version multiplies on
// fp32 CUDA cores, not the tensor cores, which keeps fp32 inputs exact but
// makes its arithmetic the real limit; wgmma and TMA are later work.  What it keeps out of device memory:
// one block per (batch * kv head, query tile) stacks the G query heads of
// that kv head into its rows, so every K/V tile it stages in shared memory is
// read once for all G heads.  Four threads share one query row, each holding
// every fourth element of the row's q and accumulator in registers.
//
// Layouts (all contiguous): q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D),
// out (B, Sq, Hq, D), Hq = Hkv * G.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_float;

constexpr int kPart = 4;    // threads per query row
constexpr int kTileK = 32;  // keys per shared-memory tile
constexpr int kRows = 64;   // query rows (heads x positions) per block

template <typename T, int D>
__global__ void __launch_bounds__(kRows * kPart)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hkv, int G, int bq, int causal, int window,
                       int q_offset, float scale) {
  constexpr int DP = D / kPart;
  __shared__ float k_s[kTileK][D];
  __shared__ float v_s[kTileK][D];

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int q0 = blockIdx.y * bq;  // first query index of this tile
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int row = tid / kPart, part = tid % kPart;
  const int g = row / bq, qi = q0 + row % bq;
  const bool active = g < G && qi < Sq;
  const int qpos = q_offset + qi;
  const size_t o_base = (((size_t)b * Sq + qi) * Hq + (size_t)kvh * G + g) * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = active ? to_float(q[o_base + i * kPart + part]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // Key range that any row of this tile can see.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q_first - window + 1) / kTileK * kTileK : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += kTileK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kTileK * D; i += blockDim.x) {
      const int t = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + t < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + t) * Hkv + kvh) * D + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      k_s[t][d] = kv;
      v_s[t][d] = vv;
    }
    __syncthreads();

    float s[kTileK];
    float m_tile = kNegInf;
#pragma unroll
    for (int t = 0; t < kTileK; ++t) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot += qr[i] * k_s[t][i * kPart + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + t;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[t] = ok ? dot : kNegInf;
      m_tile = fmaxf(m_tile, s[t]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int t = 0; t < kTileK; ++t) {
      s[t] = expf(s[t] - m_new);
      l_tile += s[t];
    }
    l = l * alpha + l_tile;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int t = 0; t < kTileK; ++t) a += s[t] * v_s[t][i * kPart + part];
      acc[i] = a;
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / (l + 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      out[o_base + i * kPart + part] = repro::from_float<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, int q_offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int bq = G >= kRows ? 1 : kRows / G;  // query positions per block
  const int threads = (G * bq * kPart + 31) / 32 * 32;
  const dim3 grid(B * Hkv, (Sq + bq - 1) / bq);
  flash_attention_kernel<T, D><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hkv, G, bq,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window.  is_bf16: 1 for bfloat16, 0 for float32.
// Returns a cudaError_t.  Head dims 32, 64 and 128 are compiled.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      int causal, int window, int q_offset,
                                      float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                        causal, window, q_offset, scale, s)
              : launch_d<float>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                                window, q_offset, scale, s);
  return static_cast<int>(err);
}
