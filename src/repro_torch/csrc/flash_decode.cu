// GQA flash decode over dense K/V, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_flash_decode.py::
// flash_decode_kernel` (body `_flash_decode_kernel`, `_accumulate_block`):
// for each (batch, kv head) row bh, the g query rows that share the kv head
// attend to the first length[bh] of the N cached tokens, with an online
// softmax over token tiles.  K/V are read in their storage type (bf16 at full
// width, or f32) and accumulated in f32.  Output: the normalised (BH, g, d)
// f32 attention; length 0 gives 0.
//
// What bounds it on the H100: bytes.  Each cached K/V element is read once
// and used by g query rows (g*2 FLOPs per element read), far below the ~295
// operations per byte at which bf16 compute would bind.  The design reads
// each K/V tile once into shared memory (rows padded by one float against
// bank conflicts) and lets all g rows use it, so device-memory traffic is the
// K/V bytes once; only tokens below length are read.  One block per bh row
// (16 blocks at batch 4): splitting the sequence across blocks (split-K) is
// later work.
//
// One block: 256 threads, token tile T = 64.
//   1. load the K and V tile (T, d) as f32;
//   2. scores s[g, t] = scale * <q[g], k[t]>, one (g, t) pair per thread step;
//   3. warp w runs the online softmax for rows w, w+8, ...;
//   4. each thread accumulates its (g, d) outputs against the V tile.
//
// The device body lives in `flash_decode_body.cuh`, shared with K4
// (`paged_flash_decode.cu`); this file supplies the dense row addressing.
#include "flash_decode_body.cuh"

namespace {

// K/V rows of a dense (BH, N, d) buffer; lengths per bh row.
template <typename T>
struct DenseRows {
  const T* base;
  int n, d, capacity;
  __device__ __forceinline__ int length(const int* len, int bh) const { return len[bh]; }
  __device__ __forceinline__ float value(int bh, int t, int dim) const {
    return fdk::to_f32(base[((size_t)bh * n + t) * d + dim]);
  }
};

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const int* length,
                 float* out, int bh, int g, int d, int n, float scale,
                 cudaStream_t stream) {
  const DenseRows<T> kr{static_cast<const T*>(k), n, d, n};
  const DenseRows<T> vr{static_cast<const T*>(v), n, d, n};
  return fdk::launch<T>(q, kr, vr, length, out, bh, g, d, scale, stream);
}

}  // namespace

extern "C" {

size_t flash_decode_smem_bytes(int g, int d) { return fdk::smem_bytes(g, d); }

int flash_decode_max_outputs() { return fdk::kMaxOut * fdk::kThreads; }

// dtype_code: 0 = bf16, 1 = f32 (q, k and v share it).  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_decode_launch(int dtype_code, const void* q, const void* k, const void* v,
                        const int* length, float* out, int bh, int g, int d, int n,
                        float scale, void* stream) {
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_dense<__nv_bfloat16>(q, k, v, length, out, bh, g, d, n, scale, s);
  if (dtype_code == 1) return launch_dense<float>(q, k, v, length, out, bh, g, d, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
