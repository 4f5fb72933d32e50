// Shared device body of the flash-decode kernels K4
// (`paged_flash_decode.cu`, K/V pages read in place from a block pool) and
// K5 (`packed_paged_flash_decode.cu`, packed pages dequantized on load).
// They differ only in how a cached token's K/V element and a row's length
// are found: the kernel is templated on a `Rows` type with
//
//   __device__ int length(const int* length, int bh) const;     // valid tokens
//   __device__ float value(int bh, int t, int dim) const;       // one element, f32
//   int capacity;                                                // tokens a row holds
//
// so K5 adds only its decode of codes and f16 headers to K4's page walk; on
// the f32 values K5 decodes, K4 gives the same bits.  K2 (`flash_decode.cu`,
// dense K/V) has its own split-K design and no longer shares this body.
//
// One block per (batch, kv head) row, 256 threads, token tile 64:
//   1. load the K and V tile (64, d) as f32 (rows padded by one float);
//   2. scores s[g, t] = scale * <q[g], k[t]>, one (g, t) pair per thread step;
//   3. warp w runs the online softmax for rows w, w+8, ...;
//   4. each thread accumulates its (g, d) outputs against the V tile.
// What bounds K4 and K5 on the H100, and what is left: see their files'
// headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fdk {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxOut = 8;  // (g*d) / kThreads outputs per thread: g*d <= 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline size_t smem_bytes(int g, int d) {
  size_t b = 0;
  b += (size_t)g * d * sizeof(float);             // q
  b += 2 * (size_t)kTile * (d + 1) * sizeof(float);  // k, v tiles (padded)
  b += (size_t)g * kTile * sizeof(float);         // scores / probabilities
  b += 3 * (size_t)g * sizeof(float);             // max, denom, alpha
  return b;
}

template <typename TQ, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, Rows krows, Rows vrows,
                    const int* __restrict__ length, float* __restrict__ out, int g,
                    int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ds = d + 1;

  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + g * d;
  float* v_s = k_s + kTile * ds;
  float* p_s = v_s + kTile * ds;
  float* mrun_s = p_s + g * kTile;
  float* lrun_s = mrun_s + g;
  float* alpha_s = lrun_s + g;

  for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(q[(size_t)bh * g * d + i]);
  for (int i = tid; i < g; i += kThreads) {
    mrun_s[i] = kNegInf;
    lrun_s[i] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;

  const int len = min(max(krows.length(length, bh), 0), krows.capacity);

  for (int n0 = 0; n0 < len; n0 += kTile) {
    const int nv = min(kTile, len - n0);
    __syncthreads();  // previous tile fully consumed (and smem init visible)
    for (int i = tid; i < nv * d; i += kThreads) {
      const int t = i / d, dim = i - t * d;
      k_s[t * ds + dim] = krows.value(bh, n0 + t, dim);
      v_s[t * ds + dim] = vrows.value(bh, n0 + t, dim);
    }
    __syncthreads();

    // 2. scores
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, t = i - gi * kTile;
      float s = kNegInf;
      if (t < nv) {
        const float* qr = q_s + gi * d;
        const float* kr = k_s + t * ds;
        float a = 0.f;
        for (int e = 0; e < d; ++e) a = fmaf(qr[e], kr[e], a);
        s = a * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // 3. online softmax: warp w owns rows w, w+8, ...
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float sv[kTile / 32];
      float mu = kNegInf;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        sv[u] = p_s[gi * kTile + lane + 32 * u];
        mu = fmaxf(mu, sv[u]);
      }
      mu = warp_max(mu);
      const float m_prev = mrun_s[gi];
      const float m_new = fmaxf(m_prev, mu);
      const float alpha = expf(m_prev - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int t = lane + 32 * u;
        const float p = (t < nv) ? expf(sv[u] - m_new) : 0.f;
        p_s[gi * kTile + t] = p;
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        lrun_s[gi] = alpha * lrun_s[gi] + lsum;
        mrun_s[gi] = m_new;
        alpha_s[gi] = alpha;
      }
    }
    __syncthreads();

    // 4. acc[g, dim] = alpha * acc + sum_t p[g, t] * v[t, dim]
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * d) {
        const int gi = e / d, dim = e - gi * d;
        const float* pr = p_s + gi * kTile;
        float a = acc[r] * alpha_s[gi];
        for (int t = 0; t < nv; ++t) a = fmaf(pr[t], v_s[t * ds + dim], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * d) out[(size_t)bh * g * d + e] = acc[r] / fmaxf(lrun_s[e / d], 1e-30f);
  }
}

// Launch one block per bh row on `stream` (q of type TQ); returns
// cudaGetLastError().
template <typename TQ, typename Rows>
int launch(const void* q, Rows krows, Rows vrows, const int* length, float* out, int bh,
           int g, int d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d);
  auto kern = flash_decode_kernel<TQ, Rows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, kThreads, smem, stream>>>(static_cast<const TQ*>(q), krows, vrows, length,
                                       out, g, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace fdk
