// GQA flash decode over dense K/V (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_flash_decode.py::
// flash_decode_kernel` (body `_flash_decode_kernel`, `_accumulate_block`):
// for each (batch, kv head) row bh, the g query rows that share the kv head
// attend to the first length[bh] of the N cached tokens.  K/V are read in
// their storage type (bf16 at full width, or f32) and all arithmetic is f32
// on the CUDA cores.  Output: the normalised (BH, g, d) f32 attention;
// length 0 gives 0.
//
// What bounds it on the H100: bytes, and at the serving shape the launch.
// Each cached K/V element is read once and used by g query rows (2g FLOP
// per element read), far below the ~295 operations per byte at which bf16
// compute would bind.  At BH 16, g 8, d 64 and 1025 tokens the K/V bytes
// take 1.27 us at 3.35 TB/s, less than one kernel launch.
//
// Design: split-K over the sequence, then a merge.
//   1. `flash_decode_split_kernel`, grid (BH, S): block (bh, s) takes the
//      chunk [s * chunk, (s + 1) * chunk) of row bh's tokens, cut at its
//      length.  The wrapper picks S and the chunk (whole 64-token tiles) from
//      the capacity N and the SM count alone
//      (`paged_flash_decode.flash_decode_split`), never from the device
//      `length`, so the step stays free of host syncs; BH * S fills the SMs
//      about twice, where one block per row left 116 of 132 SMs idle at
//      batch 4.  Tiles of 64 tokens are read with 16-byte vector loads in
//      their storage type into shared memory (rows padded by one word
//      against bank conflicts) and widened to f32 as they are read; each
//      thread scores (query row, token) pairs, warps run the online softmax
//      of their rows, and each thread accumulates its (row, dim) outputs.
//      The block writes its unnormalised partial (acc, max, denom) to f32
//      scratch; a chunk at or past the length writes (0, -inf, 0).
//   2. `flash_decode_merge_kernel`, grid (BH, g): the S partials of a query
//      row are combined in chunk order with the flash-decoding rule,
//      out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).
//      No float atomics: two calls on the same inputs are bit-equal.
//
// Left for later: the two launches cost more than the bytes at the serving
// shape; the tile loads are not double-buffered within a chunk (a chunk is
// one tile at the serving shapes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxOut = 8;  // (g*d) / kThreads outputs per thread: g*d <= 2048
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bytes of one shared-memory K or V row: the row rounded up to whole words,
// plus one word, so consecutive rows start in different banks.
template <typename T>
__host__ __device__ __forceinline__ int row_bytes(int d) {
  return (d * (int)sizeof(T) + 3) / 4 * 4 + 4;
}

template <typename T>
size_t smem_bytes(int g, int d) {
  size_t b = 0;
  b += (size_t)g * d * sizeof(float);           // q
  b += 2 * (size_t)kTile * row_bytes<T>(d);     // k, v tiles (padded rows)
  b += (size_t)g * kTile * sizeof(float);       // scores / probabilities
  b += 3 * (size_t)g * sizeof(float);           // max, denom, alpha
  return b;
}

// Rows [t0, t0 + nv) of a (N, d) row-major buffer into padded shared rows.
// VEC16: 16-byte loads (rows a whole number of 16 bytes, 16-byte aligned
// base), stored as four words; else one element at a time.
template <typename T, bool VEC16>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* __restrict__ src, int t0,
                                          int nv, int d) {
  const int rb = row_bytes<T>(d);
  if constexpr (VEC16) {
    const int vpr = d * (int)sizeof(T) / 16;  // 16-byte vectors per row
    const uint4* s = reinterpret_cast<const uint4*>(src + (size_t)t0 * d);
    for (int i = threadIdx.x; i < nv * vpr; i += kThreads) {
      const int r = i / vpr, c = i - r * vpr;
      const uint4 x = __ldg(s + (size_t)r * vpr + c);
      uint32_t* o = reinterpret_cast<uint32_t*>(dst + r * rb + c * 16);
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
  } else {
    for (int i = threadIdx.x; i < nv * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      reinterpret_cast<T*>(dst + r * rb)[e] = src[(size_t)(t0 + r) * d + e];
    }
  }
}

template <typename T, bool VEC16>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ length,
                          float* __restrict__ part_acc, float* __restrict__ part_stat, int g,
                          int d, int n, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, s = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = row_bytes<T>(d);

  float* q_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* k_s = reinterpret_cast<unsigned char*>(q_s + g * d);
  unsigned char* v_s = k_s + kTile * rb;
  float* p_s = reinterpret_cast<float*>(v_s + kTile * rb);
  float* mrun_s = p_s + g * kTile;
  float* lrun_s = mrun_s + g;
  float* alpha_s = lrun_s + g;

  const size_t part = (size_t)bh * n_split + s;
  float* acc_out = part_acc + part * g * d;
  float* stat_out = part_stat + part * 2 * g;  // (max[g], denom[g])
  const int len = min(max(length[bh], 0), n);
  const int start = s * chunk, end = min(start + chunk, len);

  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;
  if (start < end) {
    for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(q[(size_t)bh * g * d + i]);
    for (int i = tid; i < g; i += kThreads) {
      mrun_s[i] = -INFINITY;
      lrun_s[i] = 0.f;
    }
    const T* kb = k + (size_t)bh * n * d;
    const T* vb = v + (size_t)bh * n * d;
    for (int t0 = start; t0 < end; t0 += kTile) {
      const int nv = min(kTile, end - t0);
      __syncthreads();  // the previous tile is consumed (and q, stats visible)
      load_rows<T, VEC16>(k_s, kb, t0, nv, d);
      load_rows<T, VEC16>(v_s, vb, t0, nv, d);
      __syncthreads();

      // scores s[gi, t] = scale * <q[gi], k[t]>; a warp's lanes share gi
      for (int i = tid; i < g * kTile; i += kThreads) {
        const int gi = i / kTile, t = i - gi * kTile;
        float sc = -INFINITY;
        if (t < nv) {
          const float* qr = q_s + gi * d;
          const T* kr = reinterpret_cast<const T*>(k_s + t * rb);
          float a = 0.f;
          for (int e = 0; e < d; ++e) a = fmaf(qr[e], to_f32(kr[e]), a);
          sc = a * scale;
        }
        p_s[i] = sc;
      }
      __syncthreads();

      // online softmax: warp w owns rows w, w+8, ...
      for (int gi = warp; gi < g; gi += kThreads / 32) {
        float sv[kTile / 32];
        float mu = -INFINITY;
#pragma unroll
        for (int u = 0; u < kTile / 32; ++u) {
          sv[u] = p_s[gi * kTile + lane + 32 * u];
          mu = fmaxf(mu, sv[u]);
        }
        mu = warp_max(mu);
        const float m_prev = mrun_s[gi];
        const float m_new = fmaxf(m_prev, mu);  // finite: the tile has a token
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

      // acc[gi, dim] = alpha * acc + sum_t p[gi, t] * v[t, dim]
#pragma unroll
      for (int r = 0; r < kMaxOut; ++r) {
        const int e = tid + r * kThreads;
        if (e < g * d) {
          const int gi = e / d, dim = e - gi * d;
          const float* pr = p_s + gi * kTile;
          float a = acc[r] * alpha_s[gi];
          for (int t = 0; t < nv; ++t)
            a = fmaf(pr[t], to_f32(reinterpret_cast<const T*>(v_s + t * rb)[dim]), a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < g; i += kThreads) {
      stat_out[i] = mrun_s[i];
      stat_out[g + i] = lrun_s[i];
    }
  } else {
    for (int i = tid; i < g; i += kThreads) {
      stat_out[i] = -INFINITY;
      stat_out[g + i] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * d) acc_out[e] = acc[r];
  }
}

// out[bh, gi] from its S partials, combined in chunk order: each thread
// walks the chunks for its dims, the (max, denom) of the row staged in shared
// memory.
constexpr int kMergeThreads = 64;

__global__ void __launch_bounds__(kMergeThreads)
flash_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_stat,
                          float* __restrict__ out, int g, int d, int n_split) {
  extern __shared__ float ml_s[];  // max[S], then denom[S]
  const int bh = blockIdx.x, gi = blockIdx.y;
  const float* stat = part_stat + (size_t)bh * n_split * 2 * g;
  for (int s = threadIdx.x; s < n_split; s += kMergeThreads) {
    ml_s[s] = stat[(size_t)s * 2 * g + gi];
    ml_s[n_split + s] = stat[(size_t)s * 2 * g + g + gi];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml_s[s]);
  const float base = mx == -INFINITY ? 0.f : mx;  // an empty row: all weights 0
  const float* acc = part_acc + ((size_t)bh * n_split * g + gi) * d;  // chunk s at + s g d
  for (int e = threadIdx.x; e < d; e += kMergeThreads) {
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(ml_s[s] - base);
      num = fmaf(w, acc[(size_t)s * g * d + e], num);
      den = fmaf(w, ml_s[n_split + s], den);
    }
    out[((size_t)bh * g + gi) * d + e] = num / fmaxf(den, 1e-30f);
  }
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const int* length,
                 float* part_acc, float* part_stat, int bh, int g, int d, int n, int n_split,
                 int chunk, float scale, cudaStream_t stream) {
  const bool vec16 = (d * sizeof(T)) % 16 == 0 &&
                     ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  auto kern = vec16 ? flash_decode_split_kernel<T, true> : flash_decode_split_kernel<T, false>;
  const size_t smem = smem_bytes<T>(g, d);
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(bh, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      part_acc, part_stat, g, d, n, chunk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t flash_decode_smem_bytes(int dtype_code, int g, int d) {
  return dtype_code == 0 ? smem_bytes<__nv_bfloat16>(g, d) : smem_bytes<float>(g, d);
}

int flash_decode_max_outputs() { return kMaxOut * kThreads; }

// Step 1: q (BH, g, d), k and v (BH, N, d) in one type (dtype_code 0 =
// bf16, 1 = f32), length (BH,) int32 -> part_acc (BH, S, g, d) and
// part_stat (BH, S, 2, g) f32, chunk tokens per split.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_decode_split_launch(int dtype_code, const void* q, const void* k, const void* v,
                              const int* length, float* part_acc, float* part_stat, int bh,
                              int g, int d, int n, int n_split, int chunk, float scale,
                              void* stream) {
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_split<__nv_bfloat16>(q, k, v, length, part_acc, part_stat, bh, g, d, n,
                                       n_split, chunk, scale, s);
  if (dtype_code == 1)
    return launch_split<float>(q, k, v, length, part_acc, part_stat, bh, g, d, n, n_split, chunk,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}

// Step 2: the partials of step 1 -> out (BH, g, d) f32.
int flash_decode_merge_launch(const float* part_acc, const float* part_stat, float* out, int bh,
                              int g, int d, int n_split, void* stream) {
  if (bh == 0 || g == 0) return 0;
  const size_t smem = 2 * (size_t)n_split * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_decode_merge_kernel<<<dim3(bh, g), kMergeThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(part_acc, part_stat, out, g,
                                                                   d, n_split);
  return (int)cudaGetLastError();
}

// Both steps, one call: scratch holds part_acc (BH, S, g, d) then
// part_stat (BH, S, 2, g); out (BH, g, d) f32.
int flash_decode_launch(int dtype_code, const void* q, const void* k, const void* v,
                        const int* length, float* scratch, float* out, int bh, int g, int d,
                        int n, int n_split, int chunk, float scale, void* stream) {
  float* part_stat = scratch + (size_t)bh * n_split * g * d;
  int err = flash_decode_split_launch(dtype_code, q, k, v, length, scratch, part_stat, bh, g, d,
                                      n, n_split, chunk, scale, stream);
  if (err) return err;
  return flash_decode_merge_launch(scratch, part_stat, out, bh, g, d, n_split, stream);
}

}  // extern "C"
