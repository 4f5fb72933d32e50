// Shared device body of the PQ decode kernels K1 (`pq_decode.cu`, dense index
// buffers) and K3 (`pq_decode_paged.cu`, index pages read in place from a
// block pool).  The two differ only in how a body token's index row and a
// row's length are addressed: the kernel is templated on a `Rows` type with
//
//   __device__ int length(const int* length, int bh) const;  // valid tokens
//   __device__ const IT* row(int bh, int t) const;           // m indices
//   int capacity;                                             // tokens a row holds
//
// so K1 keeps its arithmetic bit for bit and K3 adds only its page walk.
// What the kernel computes and how its block is laid out: see the header of
// `pq_decode.cu`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pqd {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kParts = kThreads / kTile;
constexpr int kMaxG = 16;
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

inline size_t smem_bytes(int g, int d, int m, int k) {
  const int dsub = d / m;
  size_t b = 0;
  b += 2 * (size_t)m * k * dsub * sizeof(__nv_bfloat16);  // codebooks
  b += (size_t)g * d * sizeof(float);                     // q
  b += 2 * (size_t)kTile * (m + 1) * sizeof(int);         // index tiles
  b += (size_t)kParts * g * kTile * sizeof(float);        // partial scores
  b += (size_t)g * kTile * sizeof(float);                 // probabilities
  b += (size_t)kTile * d * sizeof(float);                 // rebuilt values
  b += 3 * (size_t)g * sizeof(float);                     // max, denom, alpha
  return b;
}

template <typename QT, typename IT, typename Rows>
__global__ void __launch_bounds__(kThreads)
pq_decode_kernel(const QT* __restrict__ q, const __nv_bfloat16* __restrict__ kcb,
                 const __nv_bfloat16* __restrict__ vcb, Rows krows, Rows vrows,
                 const int* __restrict__ length, float* __restrict__ out,
                 float* __restrict__ stats, int g, int d, int m, int K,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dsub = d / m;
  const int cb_elems = m * K * dsub;

  __nv_bfloat16* kcb_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vcb_s = kcb_s + cb_elems;
  float* q_s = reinterpret_cast<float*>(vcb_s + cb_elems);
  int* kidx_s = reinterpret_cast<int*>(q_s + g * d);
  int* vidx_s = kidx_s + kTile * (m + 1);
  float* part_s = reinterpret_cast<float*>(vidx_s + kTile * (m + 1));
  float* p_s = part_s + kParts * g * kTile;
  float* vrec_s = p_s + g * kTile;
  float* mrun_s = vrec_s + kTile * d;
  float* lrun_s = mrun_s + g;
  float* alpha_s = lrun_s + g;

  // codebooks: 16-byte copies when the row is 16-byte aligned in elements
  const __nv_bfloat16* kcb_g = kcb + (size_t)bh * cb_elems;
  const __nv_bfloat16* vcb_g = vcb + (size_t)bh * cb_elems;
  if ((cb_elems & 7) == 0 && ((reinterpret_cast<uintptr_t>(kcb_g) |
                               reinterpret_cast<uintptr_t>(vcb_g)) & 15) == 0) {
    const uint4* ks = reinterpret_cast<const uint4*>(kcb_g);
    const uint4* vs = reinterpret_cast<const uint4*>(vcb_g);
    uint4* kd = reinterpret_cast<uint4*>(kcb_s);
    uint4* vd = reinterpret_cast<uint4*>(vcb_s);
    for (int i = tid; i < cb_elems / 8; i += kThreads) {
      kd[i] = ks[i];
      vd[i] = vs[i];
    }
  } else {
    for (int i = tid; i < cb_elems; i += kThreads) {
      kcb_s[i] = kcb_g[i];
      vcb_s[i] = vcb_g[i];
    }
  }
  for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(q[(size_t)bh * g * d + i]);
  for (int i = tid; i < g; i += kThreads) {
    mrun_s[i] = kNegInf;
    lrun_s[i] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;

  const int len = min(max(krows.length(length, bh), 0), krows.capacity);
  const int part = tid / kTile;
  const int tok = tid % kTile;

  for (int n0 = 0; n0 < len; n0 += kTile) {
    const int nv = min(kTile, len - n0);
    __syncthreads();  // previous tile fully consumed (and smem init visible)
    // index rows of the tile, read in their storage width and widened here
    for (int i = tid; i < nv * m; i += kThreads) {
      const int t = i / m, j = i - t * m;
      kidx_s[t * (m + 1) + j] = (int)krows.row(bh, n0 + t)[j];
      vidx_s[t * (m + 1) + j] = (int)vrows.row(bh, n0 + t)[j];
    }
    __syncthreads();

    // 1. partial scores: this thread's token, subvectors part, part+P, ...
    {
      float s[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.f;
      if (tok < nv) {
        for (int j = part; j < m; j += kParts) {
          const int ki = kidx_s[tok * (m + 1) + j];
          const __nv_bfloat16* c = kcb_s + ((size_t)j * K + ki) * dsub;
          for (int e = 0; e < dsub; ++e) {
            const float cv = __bfloat162float(c[e]);
            const float* qj = q_s + j * dsub + e;
#pragma unroll
            for (int gi = 0; gi < kMaxG; ++gi)
              if (gi < g) s[gi] = fmaf(qj[gi * d], cv, s[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) part_s[(part * g + gi) * kTile + tok] = s[gi];
    }
    // rebuilt values of the tile (independent of the scores)
    for (int i = tid; i < kTile * d; i += kThreads) {
      const int t = i / d, dim = i - t * d;
      float v = 0.f;
      if (t < nv) {
        const int j = dim / dsub;
        const int vi = vidx_s[t * (m + 1) + j];
        v = __bfloat162float(vcb_s[((size_t)j * K + vi) * dsub + (dim - j * dsub)]);
      }
      vrec_s[i] = v;
    }
    __syncthreads();

    // 2. scale, mask and online softmax: warp w owns rows w, w+8, ...
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float sv[kTile / 32];
      float mu = kNegInf;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int t = lane + 32 * u;
        float x = 0.f;
#pragma unroll
        for (int pp = 0; pp < kParts; ++pp) x += part_s[(pp * g + gi) * kTile + t];
        x = (t < nv) ? x * scale : kNegInf;
        sv[u] = x;
        mu = fmaxf(mu, x);
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
      __syncwarp();
      if (lane == 0) {
        lrun_s[gi] = alpha * lrun_s[gi] + lsum;
        mrun_s[gi] = m_new;
        alpha_s[gi] = alpha;
      }
    }
    __syncthreads();

    // 3. acc[g, dim] = alpha * acc + sum_t p[g, t] * vrec[t, dim]
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * d) {
        const int gi = e / d, dim = e - gi * d;
        const float* pr = p_s + gi * kTile;
        float a = acc[r] * alpha_s[gi];
        for (int t = 0; t < nv; ++t) a = fmaf(pr[t], vrec_s[t * d + dim], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * d) {
      const int gi = e / d;
      out[(size_t)bh * g * d + e] = acc[r] / fmaxf(lrun_s[gi], 1e-30f);
    }
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    stats[(size_t)bh * 2 * g + gi] = mrun_s[gi];
    stats[(size_t)bh * 2 * g + g + gi] = lrun_s[gi];
  }
}

// Launch one block per bh row on `stream`; returns cudaGetLastError().
template <typename QT, typename IT, typename Rows>
int launch(const void* q, const void* kcb, const void* vcb, Rows krows, Rows vrows,
           const int* length, float* out, float* stats, int bh, int g, int d, int m,
           int K, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d, m, K);
  auto kern = pq_decode_kernel<QT, IT, Rows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kcb),
      static_cast<const __nv_bfloat16*>(vcb), krows, vrows, length, out, stats, g, d,
      m, K, scale);
  return (int)cudaGetLastError();
}

}  // namespace pqd
