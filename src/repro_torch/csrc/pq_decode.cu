// PQ decode attention on compressed KV, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/pq_decode.py::
// pq_decode_attention_kernel` (body `_pq_decode_kernel`): for each
// (batch, kv head) row bh, the score of body token n for query row g is
//   s[g, n] = scale * sum_j <q[g, j, :], C_key[j, key_idx[n, j], :]>,
// masked to n < length[bh]; an online softmax runs over token tiles; the
// values are rebuilt from the value codebook by value_idx and contracted with
// the probabilities.  Outputs: the normalised body output (BH, g, d) f32 and
// stats (BH, 2, g) f32 = [running max, denom], the flash-decoding combine
// contract.  An empty body (length 0) gives out 0, max -1e30, denom 0.
//
// What bounds it on the H100: the bytes are small (the codebooks, 2 * m*K*dsub
// bf16 = 128 KiB per row at m=32, K=512, dsub=2, plus m indices per token), so
// a row's work is a chain of shared-memory gathers.  The TPU design pins a
// table T[g, m, K] f32 in VMEM; at g=8, m=32, K=512 that is 512 KiB, over the
// 227 KB a block can hold.  This kernel keeps the two bf16 codebooks in
// dynamic shared memory instead and computes each token's score directly:
// with dsub=2 that is one 4-byte shared load per (token, subvector) feeding
// g*dsub FMAs, the same work as a table lookup per (token, subvector, g).
// One block per bh row (BH = 16 blocks at batch 4 on 132 SMs): splitting the
// sequence across blocks, merged with the same (max, denom) contract, is
// later work.
//
// Layout of one block (256 threads, token tile T = 64):
//   smem: key/value codebooks bf16 | q f32 (g, d) | index tiles int32
//         (T, m+1) x2, padded against bank conflicts | per-part partial
//         scores (P, g, T) | probabilities (g, T) | rebuilt values (T, d) |
//         running max/denom/alpha (g) x3.
//   1. P = 256 / T thread groups split the m subvectors of each token; their
//      partial scores are summed in step 2 (f32).
//   2. scores are scaled and masked; each warp runs the online softmax for
//      its query rows; the values of the tile are rebuilt into shared memory.
//   3. each thread accumulates its (g, d) outputs against the tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

size_t smem_bytes(int g, int d, int m, int k) {
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

template <typename QT, typename IT>
__global__ void __launch_bounds__(kThreads)
pq_decode_kernel(const QT* __restrict__ q, const __nv_bfloat16* __restrict__ kcb,
                 const __nv_bfloat16* __restrict__ vcb, const IT* __restrict__ kidx,
                 const IT* __restrict__ vidx, const int* __restrict__ length,
                 float* __restrict__ out, float* __restrict__ stats, int g, int d,
                 int m, int K, int n, float scale) {
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

  const int len = min(max(length[bh], 0), n);
  const IT* kidx_g = kidx + (size_t)bh * n * m;
  const IT* vidx_g = vidx + (size_t)bh * n * m;
  const int part = tid / kTile;
  const int tok = tid % kTile;

  for (int n0 = 0; n0 < len; n0 += kTile) {
    const int nv = min(kTile, len - n0);
    __syncthreads();  // previous tile fully consumed (and smem init visible)
    for (int i = tid; i < nv * m; i += kThreads) {
      const int t = i / m, j = i - t * m;
      kidx_s[t * (m + 1) + j] = (int)kidx_g[(size_t)(n0 + t) * m + j];
      vidx_s[t * (m + 1) + j] = (int)vidx_g[(size_t)(n0 + t) * m + j];
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

template <typename QT, typename IT>
int launch(const void* q, const void* kcb, const void* vcb, const void* kidx,
           const void* vidx, const int* length, float* out, float* stats, int bh,
           int g, int d, int m, int K, int n, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d, m, K);
  auto kern = pq_decode_kernel<QT, IT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kcb),
      static_cast<const __nv_bfloat16*>(vcb), static_cast<const IT*>(kidx),
      static_cast<const IT*>(vidx), length, out, stats, g, d, m, K, n, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(int idx_code, const void* q, const void* kcb, const void* vcb,
             const void* kidx, const void* vidx, const int* length, float* out,
             float* stats, int bh, int g, int d, int m, int K, int n, float scale,
             cudaStream_t stream) {
  switch (idx_code) {
    case 0:
      return launch<QT, uint8_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh, g,
                                 d, m, K, n, scale, stream);
    case 1:
      return launch<QT, int16_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh, g,
                                 d, m, K, n, scale, stream);
    case 2:
      return launch<QT, int32_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh, g,
                                 d, m, K, n, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs; the wrapper refuses shapes over the
// card's per-block limit before launching.
size_t pq_decode_smem_bytes(int g, int d, int m, int k) { return smem_bytes(g, d, m, k); }

int pq_decode_max_g() { return kMaxG; }
int pq_decode_max_outputs() { return kMaxOut * kThreads; }

// q_code: 0 = bf16, 1 = f32.  idx_code: 0 = uint8, 1 = int16, 2 = int32.
// Returns cudaGetLastError() after the launch (0 on success).
int pq_decode_attention_launch(int q_code, int idx_code, const void* q,
                               const void* kcb, const void* vcb, const void* kidx,
                               const void* vidx, const int* length, float* out,
                               float* stats, int bh, int g, int d, int m, int K, int n,
                               float scale, void* stream) {
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_code == 0)
    return launch_q<__nv_bfloat16>(idx_code, q, kcb, vcb, kidx, vidx, length, out,
                                   stats, bh, g, d, m, K, n, scale, s);
  if (q_code == 1)
    return launch_q<float>(idx_code, q, kcb, vcb, kidx, vidx, length, out, stats, bh,
                           g, d, m, K, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
