// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces paged_attention_pallas / _pa_kernel
// (src/repro/kernels/paged_attention/kernel.py).  Same semantics: the block
// table translates (sequence, logical page) -> physical pool page before each
// page is read, keys at positions >= seq_len are masked, pages past
// ceil(seq_len / page) are never touched, and the softmax runs online in fp32.
//
// Bound: bytes.  Decode reads every valid K/V row once and does 4*G*D flops
// per row (G query heads share it), far below the ~295 flops/byte at which
// the tensor cores would bind.  The design therefore reads each row of the
// pool exactly once: one block per (sequence, kv head) stages the rows of
// each page it needs into shared memory and serves all G query heads of that
// kv head from the staged copy.  Scores and the P.V products use fp32 CUDA
// cores; that is enough for a bytes-bound kernel and keeps fp32 inputs exact.
//
// seq_len == 0: the block visits no page and writes zeros, as the Pallas
// kernel does (the jnp reference returns the uniform mean of V instead).
//
// Layouts (all contiguous):
//   q (B, Hq, D), k_pages/v_pages (P, page, Hkv, D), block_table (B, max_pages)
//   int32, seq_lens (B,) int32, out (B, Hq, D).  Hq = Hkv * G.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_float;

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // keys staged in shared memory at a time

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int Hkv, int G, int D, int page, int max_pages,
                       float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int Hq = Hkv * G;
  const int ldk = D + 1;  // padded K rows: the score loop reads K by row
  float* q_s = smem;                  // (G, D), pre-scaled
  float* acc_s = q_s + G * D;         // (G, D)
  float* k_s = acc_s + G * D;         // (kChunk, D + 1)
  float* v_s = k_s + kChunk * ldk;    // (kChunk, D)
  float* p_s = v_s + kChunk * D;      // (G, kChunk) scores, then probabilities
  float* m_s = p_s + G * kChunk;      // (G,) running max
  float* l_s = m_s + G;               // (G,) running sum
  float* a_s = l_s + G;               // (G,) rescale of this chunk

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const size_t q_base = ((size_t)b * Hq + (size_t)h * G) * D;

  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_float(q[q_base + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int seq_len = seq_lens[b];
  const int used = min((seq_len + page - 1) / page, max_pages);
  const int* table = block_table + (size_t)b * max_pages;
  for (int p = 0; p < used; ++p) {
    const size_t phys = (size_t)table[p];
    const int valid = min(page, seq_len - p * page);  // unmasked keys of this page
    for (int c0 = 0; c0 < valid; c0 += kChunk) {
      const int n = min(kChunk, valid - c0);
      for (int i = tid; i < n * D; i += blockDim.x) {
        const int t = i / D, d = i % D;
        const size_t off = ((phys * page + c0 + t) * Hkv + h) * D + d;
        k_s[t * ldk + d] = to_float(k_pages[off]);
        v_s[t * D + d] = to_float(v_pages[off]);
      }
      __syncthreads();
      for (int i = tid; i < G * n; i += blockDim.x) {
        const int g = i / n, t = i % n;
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * ldk;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
        p_s[g * kChunk + t] = s;
      }
      __syncthreads();
      for (int g = warp; g < G; g += nwarps) {
        float* pr = p_s + g * kChunk;
        float mx = kNegInf;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pr[t]);
        mx = repro::warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < n; t += 32) {
          const float e = expf(pr[t] - m_new);
          pr[t] = e;
          sum += e;
        }
        sum = repro::warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      for (int i = tid; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i % D;
        const float* pr = p_s + g * kChunk;
        float s = 0.f;
        for (int t = 0; t < n; ++t) s += pr[t] * v_s[t * D + d];
        acc_s[i] = acc_s[i] * a_s[g] + s;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < G * D; i += blockDim.x) {
    out[q_base + i] = repro::from_float<T>(acc_s[i] / (l_s[i / D] + 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* seq_lens, void* out,
                   int B, int Hq, int Hkv, int D, int page, int max_pages,
                   float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)2 * G * D + (size_t)kChunk * (D + 1) + (size_t)kChunk * D +
       (size_t)G * kChunk + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), Hkv, G, D, page,
      max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32.  Returns a cudaError_t.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* seq_lens, void* out, int B,
                                      int Hq, int Hkv, int D, int page,
                                      int max_pages, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, block_table,
                                      seq_lens, out, B, Hq, Hkv, D, page,
                                      max_pages, scale, s)
              : launch<float>(q, k_pages, v_pages, block_table, seq_lens, out,
                              B, Hq, Hkv, D, page, max_pages, scale, s);
  return static_cast<int>(err);
}
