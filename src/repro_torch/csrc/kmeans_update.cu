// k-means centroid update (B0), hand-written for Hopper (sm_90a).
//
// Not the port of a Pallas kernel: the reference computes the update in plain
// JAX (`repro/core/kmeans.py::_weighted_update`), as a one-hot (N, K) matmul
// that XLA maps onto the TPU's matrix unit.  This kernel computes the same
// function for R independent problems (the flattened (batch, head, subvector)
// axes of the PQ prefill): for each row r and cluster k,
//
//   num = sum_{n : assign[n] = k} w[n] x[n],   den = sum_{n : assign[n] = k} w[n],
//   new[k] = num / den where den > 1e-12, else the old centroid (frozen),
//
// with x read as bf16 or f32 and every sum in f32.  An id outside [0, K)
// joins no cluster.  The plain version (`kernels/kmeans_update.py::
// kmeans_update_plain`) keeps the reference's one-hot form; on the card that
// form fills an (R, N, K) one-hot in device memory (512 x 1024 x 512 elements
// at the serve prefill).
//
// What bounds it on the H100: bytes.  It reads x, w and the ids once and the
// old centroids once and writes the new ones: at the serve prefill's R = 512,
// N = 1024, K = 512, dsub = 2 (x bf16) about 10.5 MB, some 3 us at 3.35 TB/s;
// its N (2 dsub + 1) additions and products per row are negligible.
//
// Design: one block per row, and deterministic: two calls give the same bits.
// Float atomics (and `index_add_`, which uses them) would sum a cluster's
// members in an order that changes from call to call, and through the
// assignment's near-ties that would move ids.  Instead the block walks its
// row in tiles of at most kTile points, in ascending n, and in each tile
// sorts the points by cluster and adds each cluster's members in ascending n
// to that cluster's running sums:
//   0. the tile's ids, weights and points are staged in shared memory (20 KiB
//      at kTile = 1024, dsub = 2);
//   1. a counting sort: each warp counts the ids of its own contiguous range
//      of the tile's points into its own column of a (K, warps) histogram
//      (integer shared-memory atomics: their order does not change the
//      counts);
//   2. an exclusive scan over (cluster, warp), cluster-major, gives every
//      warp the first slot of its points in every cluster;
//   3. each warp places its points in ascending n, 32 at a time: lanes with
//      the same id find each other (`__match_any_sync`), take their rank
//      among the lower lanes, and the lowest of them advances the slot, so
//      the order within a cluster is ascending n (a stable sort);
//   4. one thread per cluster adds its members' w and w x, in that order, to
//      the cluster's sums in shared memory (only that thread touches them).
// After the last tile the same thread divides and writes the centroid, or
// the old one for an empty cluster.  Every cluster is thus summed member by
// member in ascending n whatever the tile size, and shared memory does not
// grow with N: a row of any length fits (K is what it is sized by).  This
// is O(N + K N / kTile) a row.  The update is one launch: the division and
// the freeze are inside the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = kWarps + 1;   // a cluster's histogram row, odd: no bank conflicts
constexpr int kTile = 1024;           // points staged at a time
constexpr float kEmpty = 1e-12f;      // den at or below it: the cluster is frozen
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

int tile_of(int n) { return n < kTile ? n : kTile; }

size_t smem_bytes(int n, int k, int dsub) {
  // histogram (K, kStride) and running sums (K, dsub + 1), then per point of
  // a tile: slot, id, weight and dsub values
  return sizeof(int) * ((size_t)k * (kStride + dsub + 1) + (size_t)tile_of(n) * (3 + dsub));
}

// Exclusive prefix of v over the block (every thread calls); *total gets the
// block's sum.  warp_s holds kWarps + 1 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_s[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kWarps ? warp_s[lane] : 0;
    int wi = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) warp_s[lane] = wi - own;
    if (lane == kWarps - 1) warp_s[kWarps] = wi;
  }
  __syncthreads();
  const int res = warp_s[warp] + inc - v;
  *total = warp_s[kWarps];
  __syncthreads();  // warp_s is written again by the next call
  return res;
}

template <int DSUB, typename TX>
__global__ void __launch_bounds__(kThreads)
kmeans_update_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                     const int32_t* __restrict__ assign, const float* __restrict__ c,
                     float* __restrict__ out, int n, int k, int tile) {
  extern __shared__ __align__(16) int smem_i[];
  __shared__ int warp_s[kWarps + 1];
  int* hist = smem_i;                                         // (K, kStride)
  float* acc = reinterpret_cast<float*>(hist + (size_t)k * kStride);  // (K, DSUB + 1)
  int* perm = reinterpret_cast<int*>(acc + (size_t)k * (DSUB + 1));   // (tile) by cluster
  int* a_s = perm + tile;                          // (tile) ids, -1 outside [0, K)
  float* w_s = reinterpret_cast<float*>(a_s + tile);  // (tile)
  float* x_s = w_s + tile;                            // (tile, DSUB)

  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  // cluster kk's sums belong to thread kk % kThreads alone
  for (int kk = tid; kk < k; kk += kThreads)
#pragma unroll
    for (int d = 0; d <= DSUB; ++d) acc[(size_t)kk * (DSUB + 1) + d] = 0.f;

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int nt = min(tile, n - t0);
    const size_t row = (size_t)r * n + t0;

    // 0. stage the tile
    for (int i = tid; i < k * kStride; i += kThreads) hist[i] = 0;
    for (int i = tid; i < nt; i += kThreads) {
      const int a = assign[row + i];
      a_s[i] = (a >= 0 && a < k) ? a : -1;
      w_s[i] = w[row + i];
    }
    for (int i = tid; i < nt * DSUB; i += kThreads) x_s[i] = to_f32(x[row * DSUB + i]);
    __syncthreads();

    // 1. warp v counts the ids of points [lo, hi) into column v
    const int per = (nt + kWarps - 1) / kWarps;
    const int lo = min(warp * per, nt), hi = min(lo + per, nt);
    for (int i = lo + lane; i < hi; i += 32) {
      const int a = a_s[i];
      if (a >= 0) atomicAdd(&hist[a * kStride + warp], 1);
    }
    __syncthreads();

    // 2. exclusive scan, cluster-major: hist[k][v] = first slot of warp v's
    //    points in cluster k
    int carry = 0;
    for (int k0 = 0; k0 < k; k0 += kThreads) {
      const int kk = k0 + tid;
      int tot = 0;
      if (kk < k) {
        int* h = hist + kk * kStride;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          const int cnt = h[v];
          h[v] = tot;
          tot += cnt;
        }
      }
      int block_tot;
      const int base = carry + block_exclusive_scan(tot, warp_s, &block_tot);
      if (kk < k) {
        int* h = hist + kk * kStride;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) h[v] += base;
      }
      carry += block_tot;
    }
    __syncthreads();

    // 3. stable placement, 32 points of the warp's range at a time; afterwards
    //    hist[k][v] is the slot past warp v's points in cluster k, so cluster
    //    k holds slots [hist[k-1][kWarps-1], hist[k][kWarps-1])
    for (int b0 = lo; b0 < hi; b0 += 32) {
      const int i = b0 + lane;
      const int a = i < hi ? a_s[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      const int rank = __popc(peers & below);
      const int slot = a >= 0 ? hist[a * kStride + warp] : 0;
      __syncwarp();
      if (a >= 0) {
        perm[slot + rank] = i;
        if (rank == 0) hist[a * kStride + warp] = slot + __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();

    // 4. one thread per cluster adds the tile's members in ascending n
    for (int kk = tid; kk < k; kk += kThreads) {
      const int s = kk ? hist[(kk - 1) * kStride + kWarps - 1] : 0;
      const int e = hist[kk * kStride + kWarps - 1];
      if (s == e) continue;
      float* sums = acc + (size_t)kk * (DSUB + 1);
      float num[DSUB];
#pragma unroll
      for (int d = 0; d < DSUB; ++d) num[d] = sums[d];
      float den = sums[DSUB];
      for (int p = s; p < e; ++p) {
        const int i = perm[p];
        const float wi = w_s[i];
        den = __fadd_rn(den, wi);
#pragma unroll
        for (int d = 0; d < DSUB; ++d) num[d] = fmaf(wi, x_s[i * DSUB + d], num[d]);
      }
#pragma unroll
      for (int d = 0; d < DSUB; ++d) sums[d] = num[d];
      sums[DSUB] = den;
    }
    __syncthreads();  // the next tile restages hist and the points
  }

  // 5. the same thread per cluster divides, or keeps the old centroid
  for (int kk = tid; kk < k; kk += kThreads) {
    const float* sums = acc + (size_t)kk * (DSUB + 1);
    const float den = sums[DSUB];
    const size_t o = ((size_t)r * k + kk) * DSUB;
#pragma unroll
    for (int d = 0; d < DSUB; ++d)
      out[o + d] = den <= kEmpty ? c[o + d] : __fdiv_rn(sums[d], den);
  }
}

template <int DSUB, typename TX>
int launch(const void* x, const float* w, const int32_t* assign, const float* c, float* out,
           int r, int n, int k, cudaStream_t stream) {
  auto kern = kmeans_update_kernel<DSUB, TX>;
  const size_t smem = smem_bytes(n, k, DSUB);
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<r, kThreads, smem, stream>>>(static_cast<const TX*>(x), w, assign, c, out, n, k,
                                      tile_of(n));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_dsub(int dsub, const void* x, const float* w, const int32_t* assign, const float* c,
                float* out, int r, int n, int k, cudaStream_t s) {
  switch (dsub) {
    case 1: return launch<1, TX>(x, w, assign, c, out, r, n, k, s);
    case 2: return launch<2, TX>(x, w, assign, c, out, r, n, k, s);
    case 4: return launch<4, TX>(x, w, assign, c, out, r, n, k, s);
    case 8: return launch<8, TX>(x, w, assign, c, out, r, n, k, s);
    case 16: return launch<16, TX>(x, w, assign, c, out, r, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The block's shared memory, the static scan buffer included.
size_t kmeans_update_smem_bytes(int n, int k, int dsub) {
  return smem_bytes(n, k, dsub) + sizeof(int) * (kWarps + 1);
}

// x_dtype: 0 = bf16, 1 = f32.  x (R, N, dsub), w (R, N) f32, assign (R, N)
// int32, c (R, K, dsub) f32 -> out (R, K, dsub) f32.  Returns
// cudaGetLastError() after the launch (0 on success).
int kmeans_update_launch(int x_dtype, const void* x, const float* w, const int32_t* assign,
                         const float* c, float* out, int r, int n, int k, int dsub,
                         void* stream) {
  if (r == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_dsub<__nv_bfloat16>(dsub, x, w, assign, c, out, r, n, k, s);
  if (x_dtype == 1) return launch_dsub<float>(dsub, x, w, assign, c, out, r, n, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
