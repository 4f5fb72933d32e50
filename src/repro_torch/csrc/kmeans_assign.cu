// k-means assignment step (K6), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/kmeans_assign.py::
// kmeans_assign_kernel` (body `_assign_kernel`): for each row r of R
// independent k-means problems (the flattened (batch, head, subvector) axes
// of the PQ prefill) and each of its N points x (dsub values), the id of the
// nearest of its K centroids c, argmin_k(||c_k||^2 - 2 x.c_k) in f32 with
// ||x||^2 dropped (constant per point).  A tie takes the first index, as
// `jnp.argmin`; a NaN distance wins, as there.  x and c are read as bf16 or
// f32 and computed in f32.  Every product and sum is rounded on its own
// (`__fmul_rn`, `__fadd_rn`, no contraction), in channel order, the dot
// starting from the first product, as the plain version computes them, so the
// two give the same distances bit for bit and the same ids even on a tie.
//
// What bounds it on the H100: operations.  Every point meets every centroid
// (dsub products, dsub - 1 sums, a scale and a subtract: 2*dsub + 1
// operations), so at the prefill's R = 512, N = 1024, K = 512, dsub = 2 it
// does ~1.34 GFLOP in f32 on ~6.3 MB of inputs and outputs: ~210 operations
// per byte, above the f32 ridge of the CUDA cores (67 TFLOP/s over 3.35 TB/s
// = 20).  The tensor cores do not fit: dsub = 2 is 8x thinner than `wgmma`'s
// depth of 16 bf16 values, and their f32 accumulation does not round each
// product and sum on its own as the contract does.  Under that contract the
// FMA rate is out of reach: a (point, centroid) pair costs two multiplies,
// an add, one FMA and a compare-and-select, about 7 issued instructions.
//
// Design:
// - Each row's K centroids are staged in shared memory as 16-byte records
//   (c_0 .. c_{dsub-1}, ||c||^2, padding to a whole number of 16 bytes), read
//   by a warp at one or a few addresses (a broadcast), so one `LDS.128` feeds
//   the P = 4 points each thread holds in registers.
// - The factor of 2 folds into one FMA: fmaf(-2, dot, ||c||^2) rounds
//   ||c||^2 - 2 dot once, and 2 dot is exact in f32 short of overflow, so it
//   equals the plain version's `c_sq - 2.0 * cross` bit for bit wherever
//   nothing overflows.
// - NaN and overflow stay out of the hot loop: it compares with a strict <
//   only, and runs where every centroid value of the row (a block-wide check
//   at staging time) and every value of the thread's points is finite and at
//   most 2^56 in magnitude: then no product, sum or distance can overflow
//   (|dist| <= 2^119 at dsub <= 16) and none is NaN.  Elsewhere a thread takes
//   the exact loop: `__fsub_rn(c_sq, 2 * dot)` and the NaN-aware compare.
// - The wrapper picks a split of the K centroids over L = 1, 2 or 4
//   neighbouring lanes (`kmeans_assign.kmeans_assign_geometry`, from R, N, K
//   and the SM count) so that both the serve prefill (R = 512) and an engine
//   admission (R = 128) launch ~512 blocks of 256 threads; lane l walks
//   centroids l, l + L, ..., and the lanes combine their (dist, id) pairs with
//   shuffles, lexicographically (a NaN first, then the lower distance, then
//   the lower id), so ties and NaN resolve as in one walk.
// - The grid is one-dimensional, (row, tile of points) flattened on x, so R
//   is not held to the 65,535 of a y axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 4;              // points per thread (the wrapper's POINTS)
constexpr float kSafe = 0x1p56f;   // |x|, |c| at most this: nothing overflows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// float4 records per centroid: dsub values and ||c||^2, padded
__host__ __device__ constexpr int rec_vecs(int dsub) { return (dsub + 1 + 3) / 4; }

// (db, ib) comes before (da, ia) in jnp.argmin's order: a NaN first, then the
// lower distance, then the lower id
__device__ __forceinline__ bool before(float db, int ib, float da, int ia) {
  const bool nb = isnan(db), na = isnan(da);
  if (nb || na) return nb && (!na || ib < ia);
  return db < da || (db == da && ib < ia);
}

template <int DSUB, int L, typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const TX* __restrict__ x, const TC* __restrict__ c,
                     int32_t* __restrict__ out, int n, int k, int tiles) {
  constexpr int V = rec_vecs(DSUB);
  constexpr int kGroups = kThreads / L;   // point lanes of a block
  extern __shared__ float4 rec_s[];       // (K, V)
  const int tid = threadIdx.x;
  const int r = blockIdx.x / tiles, tile = blockIdx.x - r * tiles;

  const TC* cr = c + (size_t)r * k * DSUB;
  bool ok = true;
  for (int j = tid; j < k; j += kThreads) {
    float v[4 * V];
#pragma unroll
    for (int e = 0; e < 4 * V; ++e) v[e] = 0.f;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) {
      v[e] = to_f32(cr[(size_t)j * DSUB + e]);
      ok = ok && fabsf(v[e]) <= kSafe;
    }
    float sq = __fmul_rn(v[0], v[0]);
#pragma unroll
    for (int e = 1; e < DSUB; ++e) sq = __fadd_rn(sq, __fmul_rn(v[e], v[e]));
    v[DSUB] = sq;
#pragma unroll
    for (int u = 0; u < V; ++u)
      rec_s[j * V + u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
  }
  const bool c_ok = __syncthreads_and(ok);

  const int lane = tid % L, grp = tid / L;
  const int p0 = tile * kGroups * kP + grp;  // points p0 + i * kGroups
  const TX* xr = x + (size_t)r * n * DSUB;
  float xv[kP][DSUB];
  bool x_ok = true;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = min(p0 + i * kGroups, n - 1);  // past n: a copy, not written
#pragma unroll
    for (int e = 0; e < DSUB; ++e) {
      xv[i][e] = to_f32(xr[(size_t)p * DSUB + e]);
      x_ok = x_ok && fabsf(xv[i][e]) <= kSafe;
    }
  }

  float best[kP];
  int arg[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    best[i] = INFINITY;
    arg[i] = lane;
  }
  if (c_ok && x_ok) {
#pragma unroll 2
    for (int j = lane; j < k; j += L) {
      float cv[4 * V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float4 q = rec_s[j * V + u];
        cv[4 * u] = q.x;
        cv[4 * u + 1] = q.y;
        cv[4 * u + 2] = q.z;
        cv[4 * u + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        float dot = __fmul_rn(xv[i][0], cv[0]);
#pragma unroll
        for (int e = 1; e < DSUB; ++e) dot = __fadd_rn(dot, __fmul_rn(xv[i][e], cv[e]));
        const float dist = fmaf(-2.f, dot, cv[DSUB]);
        if (dist < best[i]) {
          best[i] = dist;
          arg[i] = j;
        }
      }
    }
  } else {
    for (int j = lane; j < k; j += L) {
      const float* cv = reinterpret_cast<const float*>(rec_s + j * V);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        float dot = __fmul_rn(xv[i][0], cv[0]);
#pragma unroll
        for (int e = 1; e < DSUB; ++e) dot = __fadd_rn(dot, __fmul_rn(xv[i][e], cv[e]));
        const float dist = __fsub_rn(cv[DSUB], 2.f * dot);
        if (dist < best[i] || (isnan(dist) && !isnan(best[i]))) {
          best[i] = dist;
          arg[i] = j;
        }
      }
    }
  }

#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], o);
      if (before(ob, oa, best[i], arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = p0 + i * kGroups;
      if (p < n) out[(size_t)r * n + p] = arg[i];
    }
  }
}

template <int DSUB, int L, typename TX, typename TC>
int launch(const void* x, const void* c, int32_t* out, int r, int n, int k,
           cudaStream_t stream) {
  const size_t smem = (size_t)k * rec_vecs(DSUB) * sizeof(float4);
  auto kern = kmeans_assign_kernel<DSUB, L, TX, TC>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kThreads / L * kP;
  const int tiles = (n + per_block - 1) / per_block;
  kern<<<(unsigned)((long long)r * tiles), kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TC*>(c), out, n, k, tiles);
  return (int)cudaGetLastError();
}

template <int DSUB, typename TX, typename TC>
int launch_lanes(int lanes, const void* x, const void* c, int32_t* out, int r, int n, int k,
                 cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<DSUB, 1, TX, TC>(x, c, out, r, n, k, s);
    case 2: return launch<DSUB, 2, TX, TC>(x, c, out, r, n, k, s);
    case 4: return launch<DSUB, 4, TX, TC>(x, c, out, r, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, typename TC>
int launch_dsub(int dsub, int lanes, const void* x, const void* c, int32_t* out, int r, int n,
                int k, cudaStream_t s) {
  switch (dsub) {
    case 1: return launch_lanes<1, TX, TC>(lanes, x, c, out, r, n, k, s);
    case 2: return launch_lanes<2, TX, TC>(lanes, x, c, out, r, n, k, s);
    case 4: return launch_lanes<4, TX, TC>(lanes, x, c, out, r, n, k, s);
    case 8: return launch_lanes<8, TX, TC>(lanes, x, c, out, r, n, k, s);
    case 16: return launch_lanes<16, TX, TC>(lanes, x, c, out, r, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t kmeans_assign_smem_bytes(int k, int dsub) {
  return (size_t)k * rec_vecs(dsub) * sizeof(float4);
}

// x (R, N, dsub), c (R, K, dsub), both contiguous; out (R, N) int32.
// dtype codes: 0 = bf16, 1 = f32, for x and c each; dsub in {1, 2, 4, 8, 16};
// lanes (the split of the K centroids) in {1, 2, 4}.  Returns
// cudaGetLastError() after the launch (0 on success).
int kmeans_assign_launch(int x_code, int c_code, const void* x, const void* c, void* out,
                         int r, int n, int k, int dsub, int lanes, void* stream) {
  if (r == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (x_code == 0 && c_code == 0)
    return launch_dsub<__nv_bfloat16, __nv_bfloat16>(dsub, lanes, x, c, o, r, n, k, s);
  if (x_code == 0 && c_code == 1)
    return launch_dsub<__nv_bfloat16, float>(dsub, lanes, x, c, o, r, n, k, s);
  if (x_code == 1 && c_code == 0)
    return launch_dsub<float, __nv_bfloat16>(dsub, lanes, x, c, o, r, n, k, s);
  if (x_code == 1 && c_code == 1)
    return launch_dsub<float, float>(dsub, lanes, x, c, o, r, n, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
