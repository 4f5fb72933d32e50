// Block-table-native PQ decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/pq_decode.py::
// pq_decode_attention_paged_kernel` (body `_pq_decode_paged_kernel`): K1's
// function (see `pq_decode.cu`) with each body token's m key/value indices
// read in place from the paged layout's index pools (P+1, L, H, blk, m)
// through the per-request block tables (B, nb) int32 and the layer.  For row
// bh = b * H + h, body token t lives in pool page tables[b, t / blk], plane
// `layer`, head h, row t % blk.  The pool is never sliced, gathered or
// densified in device memory: index rows are read narrow (uint8 at K <= 256,
// int16 at K = 512) and widened in registers.  Table entries past a row's
// length may point at the trash page P; they are never read, because the
// walk stops at length[b] like any ragged tail.  An empty body gives out 0,
// max -1e30, denom 0.
//
// What bounds it on the H100: bytes, as for K1.  Each row reads its two bf16
// codebooks once (128 KiB at m=32, K=512, dsub=2) and 2*m index bytes-wide
// entries per valid token; the arithmetic is a chain of shared-memory gathers
// well below the card's compute peak.  The design is K1's (codebooks in
// dynamic shared memory, scores computed straight from the key centroid, one
// block per bh row); the device body is shared through
// `pq_decode_body.cuh`.
//
// Page walk: the token tile stays K1's 64 tokens, so with blk = 16 one tile
// spans 4 pages.  The tile's index load runs over (token, subvector) pairs;
// each pair finds its page base from the table (consecutive threads share a
// token and so one table entry), then reads its index at row t % blk.
#include "pq_decode_body.cuh"

namespace {

// Index rows of a pool (P+1, L, H, blk, m) through tables (B, nb); lengths
// per request b = bh / H.
template <typename IT>
struct PagedRows {
  const IT* pool;
  const int* tables;
  int nb, n_heads, blk, m, capacity;
  size_t page_stride;  // elements of one page across all layers: L*H*blk*m
  size_t layer_off;    // elements before plane `layer` in a page: layer*H*blk*m
  __device__ __forceinline__ int length(const int* len, int bh) const {
    return len[bh / n_heads];
  }
  __device__ __forceinline__ const IT* row(int bh, int t) const {
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int j = t / blk;
    const int page = tables[(size_t)b * nb + j];
    return pool + page * page_stride + layer_off +
           ((size_t)h * blk + (t - j * blk)) * m;
  }
};

template <typename QT, typename IT>
int launch_paged(const void* q, const void* kcb, const void* vcb, const void* kpool,
                 const void* vpool, const int* tables, const int* length, float* out,
                 float* stats, int bh, int g, int d, int m, int K, int n_heads, int blk,
                 int nb, int n_layers, int layer, float scale, cudaStream_t stream) {
  const size_t plane = (size_t)n_heads * blk * m;
  const PagedRows<IT> kr{static_cast<const IT*>(kpool), tables, nb, n_heads, blk, m,
                         nb * blk, plane * n_layers, plane * layer};
  const PagedRows<IT> vr{static_cast<const IT*>(vpool), tables, nb, n_heads, blk, m,
                         nb * blk, plane * n_layers, plane * layer};
  return pqd::launch<QT, IT>(q, kcb, vcb, kr, vr, length, out, stats, bh, g, d, m, K,
                             scale, stream);
}

template <typename QT>
int launch_q(int idx_code, const void* q, const void* kcb, const void* vcb,
             const void* kpool, const void* vpool, const int* tables, const int* length,
             float* out, float* stats, int bh, int g, int d, int m, int K, int n_heads,
             int blk, int nb, int n_layers, int layer, float scale, cudaStream_t stream) {
  switch (idx_code) {
    case 0:
      return launch_paged<QT, uint8_t>(q, kcb, vcb, kpool, vpool, tables, length, out,
                                       stats, bh, g, d, m, K, n_heads, blk, nb,
                                       n_layers, layer, scale, stream);
    case 1:
      return launch_paged<QT, int16_t>(q, kcb, vcb, kpool, vpool, tables, length, out,
                                       stats, bh, g, d, m, K, n_heads, blk, nb,
                                       n_layers, layer, scale, stream);
    case 2:
      return launch_paged<QT, int32_t>(q, kcb, vcb, kpool, vpool, tables, length, out,
                                       stats, bh, g, d, m, K, n_heads, blk, nb,
                                       n_layers, layer, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t pq_decode_paged_smem_bytes(int g, int d, int m, int k) {
  return pqd::smem_bytes(g, d, m, k);
}

int pq_decode_paged_max_g() { return pqd::kMaxG; }
int pq_decode_paged_max_outputs() { return pqd::kMaxOut * pqd::kThreads; }

// q_code: 0 = bf16, 1 = f32.  idx_code: 0 = uint8, 1 = int16, 2 = int32.
// bh = B * n_heads rows; tables (B, nb) int32; length (B,) int32.  Returns
// cudaGetLastError() after the launch (0 on success).
int pq_decode_paged_launch(int q_code, int idx_code, const void* q, const void* kcb,
                           const void* vcb, const void* kpool, const void* vpool,
                           const int* tables, const int* length, float* out,
                           float* stats, int bh, int g, int d, int m, int K, int n_heads,
                           int blk, int nb, int n_layers, int layer, float scale,
                           void* stream) {
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_code == 0)
    return launch_q<__nv_bfloat16>(idx_code, q, kcb, vcb, kpool, vpool, tables, length,
                                   out, stats, bh, g, d, m, K, n_heads, blk, nb,
                                   n_layers, layer, scale, s);
  if (q_code == 1)
    return launch_q<float>(idx_code, q, kcb, vcb, kpool, vpool, tables, length, out,
                           stats, bh, g, d, m, K, n_heads, blk, nb, n_layers, layer,
                           scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
