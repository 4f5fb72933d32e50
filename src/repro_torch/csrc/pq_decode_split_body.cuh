// Split-K device body of the PQ decode attention: a row's body tokens are cut
// into chunks, one block per (row, chunk), each writing an unnormalised
// partial, and a second kernel merges a row's partials in chunk order.  K3
// (`pq_decode_paged.cu`) runs on it; it is templated on the same `Rows`
// interface as the one-pass body (`pq_decode_body.cuh`, which K1 keeps):
//
//   __device__ int length(const int* length, int bh) const;  // valid tokens
//   __device__ const IT* row(int bh, int t) const;           // m indices
//   int capacity;                                             // tokens a row holds
//
// so K1 can move onto it by handing over its dense rows.
//
// 1. `pq_decode_split_kernel`, grid (BH, S): block (bh, s) takes the chunk
//    [s * chunk, (s + 1) * chunk) of row bh's tokens, cut at its length.  It
//    computes what the one-pass body computes over the chunk (scores straight
//    from the key centroids, an online softmax over 64-token tiles, values
//    rebuilt from the value codebook) and writes acc (g, d) = sum_t
//    e^(s_t - m) v_t, and (m, l = sum_t e^(s_t - m)) per query row, to f32
//    scratch.  A chunk at or past the length writes the empty partial
//    (0, -1e30, 0).
//    - A block is 512 threads (16 warps: the tile's dependent shared-memory
//      chains need them; 256 measured 22 % slower).  Both codebooks are
//      copied into shared memory with `cp.async` (16 bytes a thread at a
//      time), and the copy overlaps the q load and the first tile's page
//      walk.  The block then takes ~182 KiB at m=32, K=512, dsub=2, d=64,
//      g=8: one per SM.  Staging only the key codebook and reading value
//      centroids from global memory (L2) in the rebuild (~118 KiB, two
//      blocks per SM) was no faster at the engine's shape
//      (`tools/k3_staging.py` builds that variant in a copy and times both).
//    - q is staged transposed, (d, g padded to 4), so step 1 reads four
//      query rows with one 16-byte load.
//    - The page walk runs once per token of a tile (`Rows::row`: a divide and
//      a table read), not once per (token, subvector); the index rows are then
//      read with 16-byte loads where a row is a whole number of 16 bytes.
//    - The value rebuild keeps one dim (one codebook column) per thread, and
//      step 3 splits each output's 64-long FMA chain over the tile into four
//      independent partial sums.
// 2. `pq_decode_merge_kernel`, grid (BH, g): the S partials of a query row
//    are combined in chunk order with the flash-decoding rule, M = max_s m_s,
//    denom = sum_s e^(m_s - M) l_s, out = sum_s e^(m_s - M) acc_s /
//    max(denom, 1e-30), and (M, denom) are written as the stats.  An all-empty
//    row gives out 0, max -1e30, denom 0.  No float atomics: two calls on the
//    same inputs are bit-equal.
#pragma once

#include "pq_decode_body.cuh"

namespace pqs {

using pqd::kMaxG;
using pqd::kNegInf;
using pqd::kTile;
using pqd::to_f32;
using pqd::warp_max;
using pqd::warp_sum;

constexpr int kThreads = 512;
constexpr int kParts = kThreads / kTile;
constexpr int kMaxOut = 2048 / kThreads;  // (g*d) / kThreads outputs per thread: g*d <= 2048

// Elements of one codebook, rounded up to whole 16-byte chunks of bf16.
__host__ __device__ inline int cb_slot(int m, int k, int dsub) {
  return (m * k * dsub + 7) / 8 * 8;
}

// Query rows padded to whole float4s (q is staged transposed, (d, gpad)).
__host__ __device__ inline int gpad(int g) { return (g + 3) / 4 * 4; }

// Shared memory of one split block, in the order the kernel lays it out
// (every region a whole number of 16 bytes where the next needs it).
inline size_t smem_bytes(int g, int d, int m, int k) {
  const int dsub = d / m;
  size_t b = 0;
  b += 2 * (size_t)cb_slot(m, k, dsub) * 2;  // codebooks
  b += 2 * (size_t)kTile * sizeof(void*);                          // row pointers
  b += (size_t)g * kTile * sizeof(float);                          // probabilities
  b += (size_t)kParts * g * kTile * sizeof(float);                 // partial scores
  b += (size_t)kTile * d * sizeof(float);                          // rebuilt values
  b += 2 * (size_t)kTile * (m + 1) * sizeof(int);                  // index tiles
  b += (size_t)d * gpad(g) * sizeof(float);                        // q^T
  b += 3 * (size_t)g * sizeof(float);                              // max, denom, alpha
  return b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// `count` bf16 from global `src` into shared `dst`: 16-byte asynchronous
// copies when both are 16-byte aligned and count is a multiple of 8, else
// element by element.  The caller commits and waits.
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int count) {
  if ((count & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < count / 8; i += kThreads) cp_async16(dst + 8 * i, src + 8 * i);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
}

// One tile's index rows (nv tokens of m indices, from the row pointers of the
// page walk) into padded int rows of shared memory.  VEC: 16-byte loads (a row
// is a whole number of 16 bytes, and so 16-byte aligned in the pool).
template <typename IT, bool VEC>
__device__ __forceinline__ void load_index_tile(int* dst, const IT* const* rows, int nv, int m) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(IT);
    const int vpr = m / E;
    for (int i = threadIdx.x; i < nv * vpr; i += kThreads) {
      const int t = i / vpr, c = i - t * vpr;
      union {
        uint4 u;
        IT e[E];
      } v;
      v.u = __ldg(reinterpret_cast<const uint4*>(rows[t]) + c);
      int* o = dst + t * (m + 1) + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = (int)v.e[e];
    }
  } else {
    for (int i = threadIdx.x; i < nv * m; i += kThreads) {
      const int t = i / m, j = i - t * m;
      dst[t * (m + 1) + j] = (int)rows[t][j];
    }
  }
}

template <typename QT, typename IT, typename Rows, bool VEC>
__global__ void __launch_bounds__(kThreads)
pq_decode_split_kernel(const QT* __restrict__ q, const __nv_bfloat16* __restrict__ kcb,
                       const __nv_bfloat16* __restrict__ vcb, Rows krows, Rows vrows,
                       const int* __restrict__ length, float* __restrict__ part_acc,
                       float* __restrict__ part_stat, int g, int d, int m, int K, int chunk,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, s = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dsub = d / m;
  const int cb_elems = m * K * dsub;
  const int slot = cb_slot(m, K, dsub);

  const size_t part = (size_t)bh * n_split + s;
  float* acc_out = part_acc + part * g * d;
  float* stat_out = part_stat + part * 2 * g;  // (max[g], denom[g])
  const int len = min(max(krows.length(length, bh), 0), krows.capacity);
  const int start = s * chunk, end = min(start + chunk, len);
  if (start >= end) {  // the empty partial (uniform over the block)
    for (int i = tid; i < g * d; i += kThreads) acc_out[i] = 0.f;
    for (int i = tid; i < g; i += kThreads) {
      stat_out[i] = kNegInf;
      stat_out[g + i] = 0.f;
    }
    return;
  }

  __nv_bfloat16* kcb_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vcb_s = kcb_s + slot;
  const IT** krow_s = reinterpret_cast<const IT**>(vcb_s + slot);
  const IT** vrow_s = krow_s + kTile;
  float* p_s = reinterpret_cast<float*>(vrow_s + kTile);  // 16-byte aligned: read as float4
  float* part_s = p_s + g * kTile;
  float* vrec_s = part_s + kParts * g * kTile;
  int* kidx_s = reinterpret_cast<int*>(vrec_s + kTile * d);
  int* vidx_s = kidx_s + kTile * (m + 1);
  float* q_s = reinterpret_cast<float*>(vidx_s + kTile * (m + 1));  // (d, gp)
  const int gp = gpad(g);
  float* mrun_s = q_s + d * gp;
  float* lrun_s = mrun_s + g;
  float* alpha_s = lrun_s + g;

  const __nv_bfloat16* kcb_g = kcb + (size_t)bh * cb_elems;
  const __nv_bfloat16* vcb_g = vcb + (size_t)bh * cb_elems;
  stage(kcb_s, kcb_g, cb_elems);
  stage(vcb_s, vcb_g, cb_elems);
  asm volatile("cp.async.commit_group;\n" ::);

  // while the codebooks are in flight: q, the running stats, the first page walk
  for (int i = tid; i < d * gp; i += kThreads) {
    const int c = i / gp, gi = i - c * gp;
    q_s[i] = gi < g ? to_f32(q[((size_t)bh * g + gi) * d + c]) : 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    mrun_s[i] = kNegInf;
    lrun_s[i] = 0.f;
  }
  if (tid < min(kTile, end - start)) {
    krow_s[tid] = krows.row(bh, start + tid);
    vrow_s[tid] = vrows.row(bh, start + tid);
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;
  const int part_id = tid / kTile;
  const int tok = tid % kTile;

  for (int n0 = start; n0 < end; n0 += kTile) {
    const int nv = min(kTile, end - n0);
    __syncthreads();  // previous tile consumed; codebooks, q, stats, row pointers visible
    load_index_tile<IT, VEC>(kidx_s, krow_s, nv, m);
    load_index_tile<IT, VEC>(vidx_s, vrow_s, nv, m);
    __syncthreads();

    // 1. partial scores: this thread's token, subvectors part, part+P, ...
    {
      float sc[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) sc[gi] = 0.f;
      if (tok < nv) {
        for (int j = part_id; j < m; j += kParts) {
          const int ki = kidx_s[tok * (m + 1) + j];
          const __nv_bfloat16* c = kcb_s + ((size_t)j * K + ki) * dsub;
          for (int e = 0; e < dsub; ++e) {
            const float cv = __bfloat162float(c[e]);
            const float4* qj = reinterpret_cast<const float4*>(q_s + (j * dsub + e) * gp);
#pragma unroll
            for (int u = 0; u < kMaxG / 4; ++u) {
              if (4 * u < g) {
                const float4 w = qj[u];
                sc[4 * u] = fmaf(w.x, cv, sc[4 * u]);
                sc[4 * u + 1] = fmaf(w.y, cv, sc[4 * u + 1]);
                sc[4 * u + 2] = fmaf(w.z, cv, sc[4 * u + 2]);
                sc[4 * u + 3] = fmaf(w.w, cv, sc[4 * u + 3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) part_s[(part_id * g + gi) * kTile + tok] = sc[gi];
    }
    // rebuilt values of the tile (independent of the scores): where d
    // divides the block, a thread keeps one dim (and so one subvector and
    // one codebook column) for every token it rebuilds
    if (kThreads % d == 0) {
      const int dim = tid % d, j = dim / dsub;
      const __nv_bfloat16* col = vcb_s + (size_t)j * K * dsub + (dim - j * dsub);
      for (int t = tid / d; t < kTile; t += kThreads / d)
        vrec_s[t * d + dim] =
            t < nv ? __bfloat162float(col[vidx_s[t * (m + 1) + j] * dsub]) : 0.f;
    } else {
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

    // 3. acc[g, dim] = alpha * acc + sum_t p[g, t] * vrec[t, dim], the sum
    //    over t in four independent chains (p is 0 past nv)
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * d) {
        const int gi = e / d, dim = e - gi * d;
        const float4* pr = reinterpret_cast<const float4*>(p_s + gi * kTile);
        const float* vr = vrec_s + dim;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int t4 = 0; t4 < (nv + 3) / 4; ++t4) {
          const float4 p = pr[t4];
          const float* v = vr + 4 * t4 * d;
          a0 = fmaf(p.x, v[0], a0);
          a1 = fmaf(p.y, v[d], a1);
          a2 = fmaf(p.z, v[2 * d], a2);
          a3 = fmaf(p.w, v[3 * d], a3);
        }
        acc[r] = fmaf(acc[r], alpha_s[gi], (a0 + a1) + (a2 + a3));
      }
    }
    // the next tile's page walk (the row pointers are read before step 1)
    const int n1 = n0 + kTile;
    if (n1 < end && tid < min(kTile, end - n1)) {
      krow_s[tid] = krows.row(bh, n1 + tid);
      vrow_s[tid] = vrows.row(bh, n1 + tid);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * d) acc_out[e] = acc[r];
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    stat_out[gi] = mrun_s[gi];
    stat_out[g + gi] = lrun_s[gi];
  }
}

// out[bh, gi] and its stats from the S partials, combined in chunk order:
// each thread walks the chunks for its dims, the (max, denom) of the row
// staged in shared memory.
constexpr int kMergeThreads = 64;

__global__ void __launch_bounds__(kMergeThreads)
pq_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_stat,
                       float* __restrict__ out, float* __restrict__ stats, int g, int d,
                       int n_split) {
  extern __shared__ float ml_s[];  // max[S], then denom[S]
  const int bh = blockIdx.x, gi = blockIdx.y;
  const float* stat = part_stat + (size_t)bh * n_split * 2 * g;
  for (int s = threadIdx.x; s < n_split; s += kMergeThreads) {
    ml_s[s] = stat[(size_t)s * 2 * g + gi];
    ml_s[n_split + s] = stat[(size_t)s * 2 * g + g + gi];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml_s[s]);
  const float* acc = part_acc + ((size_t)bh * n_split * g + gi) * d;  // chunk s at + s g d
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) den = fmaf(expf(ml_s[s] - mx), ml_s[n_split + s], den);
  for (int e = threadIdx.x; e < d; e += kMergeThreads) {
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) num = fmaf(expf(ml_s[s] - mx), acc[(size_t)s * g * d + e], num);
    out[((size_t)bh * g + gi) * d + e] = num / fmaxf(den, 1e-30f);
  }
  if (threadIdx.x == 0) {
    stats[(size_t)bh * 2 * g + gi] = mx;
    stats[(size_t)bh * 2 * g + g + gi] = den;
  }
}

// The split kernel over grid (bh, n_split) on `stream`; returns
// cudaGetLastError().
template <typename QT, typename IT, typename Rows>
int launch_split(const void* q, const void* kcb, const void* vcb, Rows krows, Rows vrows,
                 bool vec, const int* length, float* part_acc, float* part_stat, int bh, int g,
                 int d, int m, int K, int n_split, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d, m, K);
  auto kern = vec ? pq_decode_split_kernel<QT, IT, Rows, true>
                  : pq_decode_split_kernel<QT, IT, Rows, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(bh, n_split), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kcb),
      static_cast<const __nv_bfloat16*>(vcb), krows, vrows, length, part_acc, part_stat, g, d, m,
      K, chunk, scale);
  return (int)cudaGetLastError();
}

// The merge kernel over grid (bh, g); returns cudaGetLastError().
inline int launch_merge(const float* part_acc, const float* part_stat, float* out, float* stats,
                        int bh, int g, int d, int n_split, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n_split * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_decode_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pq_decode_merge_kernel<<<dim3(bh, g), kMergeThreads, smem, stream>>>(part_acc, part_stat, out,
                                                                       stats, g, d, n_split);
  return (int)cudaGetLastError();
}

}  // namespace pqs
