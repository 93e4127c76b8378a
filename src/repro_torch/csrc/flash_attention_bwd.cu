// Backward GQA flash attention for Hopper (sm_90a): fp32 arithmetic on CUDA
// cores, bf16 or fp32 inputs and outputs.  The wrapper's rule
// (kernels/flash_attention/kernel.py::bwd_route) sends it fp32 calls and
// bf16 at D 320; bf16 at D 32, 64 and 128 takes the tensor cores
// (flash_attention_bwd_wgmma.cu).
//
// The gradient of flash_attention_pallas / _fa_kernel
// (src/repro/kernels/flash_attention/kernel.py).  The JAX package has no
// Pallas backward: it differentiates its chunked jnp path and recomputes
// attention under jax.checkpoint.  Same semantics as the forward: scale
// D**-0.5 (or the caller's), causal masking at q_offset, an optional sliding
// window (keys with kpos > qpos - window), ragged Sq and Sk, G = Hq / Hkv
// query heads over each K/V head.  Given q, k, v, the forward's output o and
// its gradient do, it computes what attention_bwd_ref
// (kernels/flash_attention/ref.py) computes:
//
//   P  = softmax(q k^T * scale) over the unmasked keys (0 where masked)
//   dV = P^T dO, summed over the G query heads of each K/V head
//   dP = dO V^T,  dS = P o (dP - rowsum(dO o O))
//   dQ = dS K * scale,  dK = dS^T Q * scale (summed over the G heads)
//
// A row that sees no key (a window or q_offset that masks it whole) has
// P = 0 and gets zero gradients.  The forward is left as it is: the
// softmax statistics are recomputed here, not read from it.
//
// Two kernels on the caller's stream, no atomics, every sum in a fixed
// order, so two calls give the same bits:
//   1. flash_bwd_dq_kernel, one block per (batch, query head, query tile):
//      a first pass over the key tiles the tile can see computes each row's
//      log-sum-exp; it also computes delta = rowsum(dO o O), and writes both
//      out; a second pass recomputes P and dP a key tile at a time and
//      accumulates dQ in registers.
//   2. flash_bwd_dkdv_kernel, one block per (batch, K/V head, key tile):
//      K and V stay in shared memory while the block walks the G query
//      heads and every query tile that reaches its keys, accumulating dK
//      and dV in registers.
//
// Bound: per call the backward does about 4x the forward's products (S
// twice in the dQ kernel and once in the dK/dV kernel, dP twice, dQ, dK,
// dV), all as fp32 FMAs on CUDA cores, against a bound of 2.5x the
// forward's products at the tensor cores' bf16 rate; so it is bound by its
// operations, and by shared-memory loads before the FMA pipes (16 loads
// for 32 FMAs a thread in the inner loops).  What it keeps out of device
// memory: P and dS never leave shared memory; each tile of K, V, Q and dO
// is read from device memory once per block that uses it.
//
// Threads: 256 a block as a 16 x 16 grid (ty, tx).  In a product with a
// BQ x BK output (S, dP) a thread holds rows ty + 16 i and columns
// tx + 16 j; in the dK/dV (BK x D) and dQ (BQ x D) accumulators rows
// ty + 16 i and head-dim columns tx + 16 j.  Shared rows are padded by one
// float, so the 16 rows a half-warp reads at one d fall in 16 banks.
//
// Layouts (all contiguous): q, o, do, dq (B, Sq, Hq, D); k, v, dk, dv
// (B, Sk, Hkv, D); lse and delta scratch (B, Hq, Sq) fp32.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_float;
using repro::from_float;

constexpr int kThreads = 256;   // 16 x 16

// Query rows (BQ) and keys (BK) a tile, by head dim: the dK/dV kernel holds
// K, V, Q, dO, P and dS tiles in shared memory (D 320: 127 KiB).
template <int D> struct Tiles;
template <> struct Tiles<32> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 32, BK = 64; };
template <> struct Tiles<320> { static constexpr int BQ = 16, BK = 32; };

template <int D>
struct Smem {
  static constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  static constexpr int DP = D + 1, KP = BK + 1;   // padded row strides
  // dQ kernel: q, do, k, v, dS tiles; lse and delta of the rows
  static constexpr int dq_floats = 2 * BQ * DP + 2 * BK * DP + BQ * KP + 2 * BQ;
  // dK/dV kernel: k, v, q, do, P, dS tiles; lse and delta of the rows
  static constexpr int dkdv_floats = 2 * BK * DP + 2 * BQ * DP + 2 * BQ * KP + 2 * BQ;
};

__device__ __forceinline__ bool visible(int qi, int kpos, int Sq, int Sk,
                                        int causal, int window, int q_offset) {
  const int qpos = q_offset + qi;
  bool ok = qi < Sq && kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// rows [r0, r0 + R) of a (S, H, D) sequence at head h into a padded tile
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int R, int S, int H,
                                          int h) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int t = i / D, d = i % D;
    float x = 0.f;
    if (r0 + t < S) x = to_float(src[(((size_t)b * S + r0 + t) * H + h) * D + d]);
    dst[t * (D + 1) + d] = x;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over D, both tiles padded
template <int D, int RI, int CJ>
__device__ __forceinline__ void tile_dot(float (&s)[RI][CJ], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] += av[i] * bv[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ delta_out,
                    int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                    int q_offset, float scale) {
  using S_ = Smem<D>;
  constexpr int BQ = S_::BQ, BK = S_::BK, DP = S_::DP, KP = S_::KP;
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * DP;
  float* k_s = do_s + BQ * DP;
  float* v_s = k_s + BK * DP;
  float* ds_s = v_s + BK * DP;
  float* lse_s = ds_s + BQ * KP;
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, kvh = h / (Hq / Hkv);
  // heaviest causal tiles (the last queries) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_rows<T, D>(q_s, q, b, q0, BQ, Sq, Hq, h);
  load_rows<T, D>(do_s, dout, b, q0, BQ, Sq, Hq, h);
  __syncthreads();

  // Keys any row of the tile can see.
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, qpos_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, qpos_first - window + 1) / BK * BK : 0;

  // Pass 1: each row's max and sum over its visible keys (per thread over
  // its columns, merged across the 16 lanes of a row after the loop).
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(k_s, k, b, k0, BK, Sk, Hkv, kvh);
    __syncthreads();
    float s[RI][CJ];
    tile_dot<D, RI, CJ>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        if (visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, window, q_offset))
          mt = fmaxf(mt, s[i][j] * scale);
      float sum = l[i] * expf(m[i] - mt);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        if (visible(qi, k0 + tx + 16 * j, Sq, Sk, causal, window, q_offset))
          sum += expf(s[i][j] * scale - mt);
      m[i] = mt;
      l[i] = sum;
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    // merge the 16 lanes of row ty + 16 i (tx is the low 4 bits of the lane)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
    // delta = rowsum(dO o O), O read once from device memory
    const int row = ty + 16 * i, qi = q0 + row;
    float part = 0.f;
    if (qi < Sq) {
      const size_t base = (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        part += do_s[row * DP + tx + 16 * j] * to_float(o[base + tx + 16 * j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0) {
      const float lse = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
      lse_s[row] = lse;
      delta_s[row] = part;
      if (qi < Sq) {
        const size_t r = ((size_t)b * Hq + h) * Sq + qi;
        lse_out[r] = lse;
        delta_out[r] = part;
      }
    }
  }

  // Pass 2: dQ = sum over key tiles of dS K.
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(k_s, k, b, k0, BK, Sk, Hkv, kvh);
    load_rows<T, D>(v_s, v, b, k0, BK, Sk, Hkv, kvh);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
    tile_dot<D, RI, CJ>(s, q_s, k_s, ty, tx);
    tile_dot<D, RI, CJ>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        const float p = visible(q0 + row, k0 + col, Sq, Sk, causal, window, q_offset)
                            ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        ds_s[row * KP + col] = p * (dp[i][j] - delta_s[row]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = ds_s[(ty + 16 * i) * KP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += sv[i] * kv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const size_t base = (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                      int Hkv, int G, int causal, int window, int q_offset,
                      float scale) {
  using S_ = Smem<D>;
  constexpr int BQ = S_::BQ, BK = S_::BK, DP = S_::DP, KP = S_::KP;
  constexpr int RI = BQ / 16, CJ = BK / 16, KI = BK / 16, DJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * DP;
  float* q_s = v_s + BK * DP;
  float* do_s = q_s + BQ * DP;
  float* p_s = do_s + BQ * DP;
  float* ds_s = p_s + BQ * KP;
  float* lse_s = ds_s + BQ * KP;
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BK;   // causal: the heaviest key tiles first
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_rows<T, D>(k_s, k, b, k0, BK, Sk, Hkv, kvh);
  load_rows<T, D>(v_s, v, b, k0, BK, Sk, Hkv, kvh);

  // Queries that can see any key of the tile.
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;

  float dk_acc[KI][DJ], dv_acc[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_lo / BQ * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile is consumed
      load_rows<T, D>(q_s, q, b, q0, BQ, Sq, Hq, h);
      load_rows<T, D>(do_s, dout, b, q0, BQ, Sq, Hq, h);
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        const size_t idx = ((size_t)b * Hq + h) * Sq + q0 + r;
        lse_s[r] = in ? lse[idx] : 0.f;
        delta_s[r] = in ? delta[idx] : 0.f;
      }
      __syncthreads();
      float s[RI][CJ], dp[RI][CJ];
      tile_dot<D, RI, CJ>(s, q_s, k_s, ty, tx);
      tile_dot<D, RI, CJ>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int col = tx + 16 * j;
          const float p = visible(q0 + row, k0 + col, Sq, Sk, causal, window, q_offset)
                              ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
          p_s[row * KP + col] = p;
          ds_s[row * KP + col] = p * (dp[i][j] - delta_s[row]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[KI], sv[KI], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pv[i] = p_s[r * KP + ty + 16 * i];
          sv[i] = ds_s[r * KP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = do_s[r * DP + tx + 16 * j];
          qv[j] = q_s[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] += pv[i] * ov[j];
            dk_acc[i][j] += sv[i] * qv[j];
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
    const size_t base = (((size_t)b * Sk + kpos) * Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = from_float<T>(dk_acc[i][j] * scale);
      dv[base + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* delta, int B, int Sq, int Sk, int Hq, int Hkv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using S_ = Smem<D>;
  const int dq_bytes = S_::dq_floats * (int)sizeof(float);
  const int dkdv_bytes = S_::dkdv_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(B * Hq, (Sq + S_::BQ - 1) / S_::BQ);
  flash_bwd_dq_kernel<T, D><<<dq_grid, kThreads, dq_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq),
      lse, delta, Sq, Sk, Hq, Hkv, causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid(B * Hkv, (Sk + S_::BK - 1) / S_::BK);
  flash_bwd_dkdv_kernel<T, D><<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Sk, Hkv, Hq / Hkv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int B, int Sq, int Sk,
                     int Hq, int Hkv, int causal, int window, int q_offset,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, Hq, Hkv,
                           causal, window, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, Hq, Hkv,
                           causal, window, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, Hq, Hkv,
                            causal, window, q_offset, scale, s);
    case 320:
      return launch<T, 320>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, Hq, Hkv,
                            causal, window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, do, dq, dk, dv of one dtype: bf16 when bf16 != 0, else fp32;
// lse and delta are fp32 (B, Hq, Sq) scratch, written by the first kernel
// and read by the second.  window <= 0 means no window.  Head dims 32, 64,
// 128 and 320 are compiled.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, void* dq, void* dk,
                                          void* dv, void* lse, void* delta,
                                          int bf16, int B, int Sq, int Sk,
                                          int Hq, int Hkv, int D, int causal,
                                          int window, int q_offset, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk,
                                     Hq, Hkv, causal, window, q_offset, scale, s)
           : dispatch<float>(D, q, k, v, o, dout, dq, dk, dv, l, dl, B, Sq, Sk, Hq,
                             Hkv, causal, window, q_offset, scale, s);
  return static_cast<int>(err);
}
