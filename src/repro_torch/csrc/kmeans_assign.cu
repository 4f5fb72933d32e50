// k-means assignment step (K6), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/kmeans_assign.py::
// kmeans_assign_kernel` (body `_assign_kernel`): for each row r of R
// independent k-means problems (the flattened (batch, head, subvector) axes
// of the PQ prefill) and each of its N points x (dsub values), the id of the
// nearest of its K centroids c, argmin_k(||c_k||^2 - 2 x.c_k) in f32 with
// ||x||^2 dropped (constant per point).  A tie takes the first index, as
// `jnp.argmin` (the K loop compares with a strict <); a NaN distance wins,
// as there.  x and c are read as bf16 or f32 and computed in f32.  Every
// product and sum is rounded on its own (`__fmul_rn`, `__fadd_rn`, no FMA
// contraction), in channel order, as the plain version computes them, so
// the two give the same distances bit for bit and the same ids even on a
// tie.
//
// What bounds it on the H100: operations.  Every point meets every centroid
// (dsub FMAs, a scale and a subtract: 2*dsub + 2 operations), so at the
// prefill's R = 512, N = 1024, K = 512, dsub = 2 it does ~1.6 GFLOP in f32
// on ~6 MB of inputs and outputs: ~250 operations per byte, above the f32
// ridge of the CUDA cores (67 TFLOP/s over 3.35 TB/s = 20).  dsub is 2-4 in
// the shipped configs, too thin for the tensor cores, so the products run on
// the CUDA cores.  The design keeps each row's K centroids and their
// ||c||^2 in shared memory (K * (dsub + 1) * 4 bytes: 6 KiB at full width),
// read by all threads at the same address (a broadcast, no bank conflict),
// and each thread holds one point in registers and walks the K centroids;
// the TPU kernel's grid over m becomes the grid's y axis (one block per
// (row, tile of 256 points)), so nothing carries over between blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int DSUB, typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const TX* __restrict__ x, const TC* __restrict__ c,
                     int32_t* __restrict__ out, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;                 // (K, DSUB)
  float* csq_s = smem + k * DSUB;    // (K,)
  const int r = blockIdx.y;
  const TC* cr = c + (size_t)r * k * DSUB;
  for (int i = threadIdx.x; i < k * DSUB; i += kThreads) c_s[i] = to_f32(cr[i]);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) s = __fadd_rn(s, __fmul_rn(c_s[j * DSUB + e], c_s[j * DSUB + e]));
    csq_s[j] = s;
  }
  __syncthreads();

  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const TX* xt = x + ((size_t)r * n + t) * DSUB;
  float xr[DSUB];
#pragma unroll
  for (int e = 0; e < DSUB; ++e) xr[e] = to_f32(xt[e]);
  float best = INFINITY;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) dot = __fadd_rn(dot, __fmul_rn(xr[e], c_s[j * DSUB + e]));
    const float dist = __fsub_rn(csq_s[j], 2.f * dot);
    if (dist < best || (isnan(dist) && !isnan(best))) {
      best = dist;
      arg = j;
    }
  }
  out[(size_t)r * n + t] = arg;
}

template <int DSUB, typename TX, typename TC>
int launch(const void* x, const void* c, int32_t* out, int r, int n, int k,
           cudaStream_t stream) {
  const size_t smem = (size_t)k * (DSUB + 1) * sizeof(float);
  auto kern = kmeans_assign_kernel<DSUB, TX, TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kThreads - 1) / kThreads, r);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const TX*>(x),
                                         static_cast<const TC*>(c), out, n, k);
  return (int)cudaGetLastError();
}

template <typename TX, typename TC>
int launch_dsub(int dsub, const void* x, const void* c, int32_t* out, int r, int n,
                int k, cudaStream_t s) {
  switch (dsub) {
    case 1: return launch<1, TX, TC>(x, c, out, r, n, k, s);
    case 2: return launch<2, TX, TC>(x, c, out, r, n, k, s);
    case 4: return launch<4, TX, TC>(x, c, out, r, n, k, s);
    case 8: return launch<8, TX, TC>(x, c, out, r, n, k, s);
    case 16: return launch<16, TX, TC>(x, c, out, r, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t kmeans_assign_smem_bytes(int k, int dsub) {
  return (size_t)k * (dsub + 1) * sizeof(float);
}

// x (R, N, dsub), c (R, K, dsub), both contiguous; out (R, N) int32.
// dtype codes: 0 = bf16, 1 = f32, for x and c each; dsub in {1, 2, 4, 8, 16}.
// Returns cudaGetLastError() after the launch (0 on success).
int kmeans_assign_launch(int x_code, int c_code, const void* x, const void* c, void* out,
                         int r, int n, int k, int dsub, void* stream) {
  if (r == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (x_code == 0 && c_code == 0)
    return launch_dsub<__nv_bfloat16, __nv_bfloat16>(dsub, x, c, o, r, n, k, s);
  if (x_code == 0 && c_code == 1)
    return launch_dsub<__nv_bfloat16, float>(dsub, x, c, o, r, n, k, s);
  if (x_code == 1 && c_code == 0)
    return launch_dsub<float, __nv_bfloat16>(dsub, x, c, o, r, n, k, s);
  if (x_code == 1 && c_code == 1) return launch_dsub<float, float>(dsub, x, c, o, r, n, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
