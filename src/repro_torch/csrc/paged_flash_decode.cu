// Block-table-native GQA flash decode, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_flash_decode.py::
// paged_flash_decode_kernel` (body `_paged_flash_decode_kernel`): K2's
// function (see `flash_decode.cu`) over the paged layout's K/V pools
// (P+1, L, H, blk, d) read in place through the per-request block tables
// (B, nb) int32 and the layer.  For row bh = b * H + h, cached token t lives
// in pool page tables[b, t / blk], plane `layer`, head h, row t % blk.  Only
// pages with j * blk < length[b] are read; entries past the length may point
// at the trash page P and are never touched.  K/V are read in their storage
// type (bf16 at full width, or f32) and accumulated in f32.  Output: the
// normalised (BH, g, d) f32 attention; length 0 gives 0.
//
// What bounds it on the H100: bytes, as for K2.  Each cached K/V element is
// read once and used by the g query rows that share its kv head (2*g FLOPs
// per element), far below the ~295 operations per byte at which bf16 compute
// would bind.  The design is K2's first one (a K/V tile in shared memory
// used by all g rows, online softmax over tiles, one block per bh row), kept
// in `flash_decode_body.cuh`, which K5 shares; K2 itself now splits the
// sequence over blocks (`flash_decode.cu`).
//
// Page walk: the token tile is 64 tokens, so with blk = 16 one tile
// spans 4 pages.  The tile load runs over (token, dim) pairs; each pair finds
// its page base from the table (the d consecutive threads of one token share
// one table entry) and reads row t % blk of that page's (layer, head) plane,
// so each page's d-wide rows are read contiguously.
#include "flash_decode_body.cuh"

namespace {

// K/V rows of a pool (P+1, L, H, blk, d) through tables (B, nb); lengths per
// request b = bh / H.
template <typename T>
struct PagedRows {
  const T* pool;
  const int* tables;
  int nb, n_heads, blk, d, capacity;
  size_t page_stride;  // elements of one page across all layers: L*H*blk*d
  size_t layer_off;    // elements before plane `layer` in a page: layer*H*blk*d
  __device__ __forceinline__ int length(const int* len, int bh) const {
    return len[bh / n_heads];
  }
  __device__ __forceinline__ float value(int bh, int t, int dim) const {
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int j = t / blk;
    const int page = tables[(size_t)b * nb + j];
    return fdk::to_f32(pool[page * page_stride + layer_off +
                            ((size_t)h * blk + (t - j * blk)) * d + dim]);
  }
};

template <typename T>
int launch_paged(const void* q, const void* kpool, const void* vpool, const int* tables,
                 const int* length, float* out, int bh, int g, int d, int n_heads,
                 int blk, int nb, int n_layers, int layer, float scale,
                 cudaStream_t stream) {
  const size_t plane = (size_t)n_heads * blk * d;
  const PagedRows<T> kr{static_cast<const T*>(kpool), tables, nb, n_heads, blk, d,
                        nb * blk, plane * n_layers, plane * layer};
  const PagedRows<T> vr{static_cast<const T*>(vpool), tables, nb, n_heads, blk, d,
                        nb * blk, plane * n_layers, plane * layer};
  return fdk::launch<T>(q, kr, vr, length, out, bh, g, d, scale, stream);
}

}  // namespace

extern "C" {

size_t paged_flash_decode_smem_bytes(int g, int d) { return fdk::smem_bytes(g, d); }

int paged_flash_decode_max_outputs() { return fdk::kMaxOut * fdk::kThreads; }

// dtype_code: 0 = bf16, 1 = f32 (q and the pools share it).  bh = B * n_heads
// rows; tables (B, nb) int32; length (B,) int32.  Returns cudaGetLastError()
// after the launch (0 on success).
int paged_flash_decode_launch(int dtype_code, const void* q, const void* kpool,
                              const void* vpool, const int* tables, const int* length,
                              float* out, int bh, int g, int d, int n_heads, int blk,
                              int nb, int n_layers, int layer, float scale,
                              void* stream) {
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_paged<__nv_bfloat16>(q, kpool, vpool, tables, length, out, bh, g, d,
                                       n_heads, blk, nb, n_layers, layer, scale, s);
  if (dtype_code == 1)
    return launch_paged<float>(q, kpool, vpool, tables, length, out, bh, g, d, n_heads,
                               blk, nb, n_layers, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
