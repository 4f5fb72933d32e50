// Block-table-native PQ decode attention (K3), hand-written for Hopper (sm_90a).
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
// What bounds it on the H100: bytes, as for K1 (each row reads its two bf16
// codebooks once, 128 KiB at m=32, K=512, dsub=2, and 2*m narrow indices per
// valid token: ~1.2 us at 3.35 TB/s at the engine's shape), but one block per
// (batch, kv head) left 116 of 132 SMs idle at batch 4 and ran a row's tiles
// in series, so the kernel was bound by latency and parallelism.
//
// Design: split-K over the sequence, then a merge (`pq_decode_split_body.cuh`
// says what each kernel does and how its block is laid out).  The wrapper
// picks the split S and the chunk (whole 64-token tiles) from the capacity
// nb * blk and the SM count alone (`pq_decode.pq_decode_paged_split`), never
// from the device `length`, so the decode step stays free of host syncs; a
// block (both codebooks staged) fits once per SM, so BH * S is kept within
// one wave of the SMs.  Both kernels are launched from one C call.
#include "pq_decode_split_body.cuh"

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
    return pool + page * page_stride + layer_off + ((size_t)h * blk + (t - j * blk)) * m;
  }
};

struct Geometry {
  int bh, g, d, m, K, n_heads, blk, nb, n_layers, layer, n_split, chunk;
};

template <typename QT, typename IT>
int split_paged(const void* q, const void* kcb, const void* vcb, const void* kpool,
                const void* vpool, const int* tables, const int* length, float* part_acc,
                float* part_stat, const Geometry& G, float scale, cudaStream_t stream) {
  const size_t plane = (size_t)G.n_heads * G.blk * G.m;
  const PagedRows<IT> kr{static_cast<const IT*>(kpool), tables, G.nb, G.n_heads, G.blk, G.m,
                         G.nb * G.blk, plane * G.n_layers, plane * G.layer};
  const PagedRows<IT> vr{static_cast<const IT*>(vpool), tables, G.nb, G.n_heads, G.blk, G.m,
                         G.nb * G.blk, plane * G.n_layers, plane * G.layer};
  const bool vec = (G.m * sizeof(IT)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kpool) | reinterpret_cast<uintptr_t>(vpool)) &
                    15) == 0;
  return pqs::launch_split<QT, IT>(q, kcb, vcb, kr, vr, vec, length, part_acc, part_stat, G.bh,
                                   G.g, G.d, G.m, G.K, G.n_split, G.chunk, scale, stream);
}

template <typename QT>
int split_q(int idx_code, const void* q, const void* kcb, const void* vcb, const void* kpool,
            const void* vpool, const int* tables, const int* length, float* part_acc,
            float* part_stat, const Geometry& G, float scale, cudaStream_t stream) {
  switch (idx_code) {
    case 0:
      return split_paged<QT, uint8_t>(q, kcb, vcb, kpool, vpool, tables, length, part_acc,
                                      part_stat, G, scale, stream);
    case 1:
      return split_paged<QT, int16_t>(q, kcb, vcb, kpool, vpool, tables, length, part_acc,
                                      part_stat, G, scale, stream);
    case 2:
      return split_paged<QT, int32_t>(q, kcb, vcb, kpool, vpool, tables, length, part_acc,
                                      part_stat, G, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t pq_decode_paged_smem_bytes(int g, int d, int m, int k) {
  return pqs::smem_bytes(g, d, m, k);
}

int pq_decode_paged_max_g() { return pqs::kMaxG; }
int pq_decode_paged_max_outputs() { return pqs::kMaxOut * pqs::kThreads; }

// Step 1.  q_code: 0 = bf16, 1 = f32.  idx_code: 0 = uint8, 1 = int16,
// 2 = int32.  bh = B * n_heads rows; tables (B, nb) int32; length (B,)
// int32 -> part_acc (BH, S, g, d) and part_stat (BH, S, 2, g) f32, chunk
// tokens per split.  Returns cudaGetLastError() after the launch (0 on
// success).
int pq_decode_paged_split_launch(int q_code, int idx_code, const void* q, const void* kcb,
                                 const void* vcb, const void* kpool, const void* vpool,
                                 const int* tables, const int* length, float* part_acc,
                                 float* part_stat, int bh, int g, int d, int m, int K,
                                 int n_heads, int blk, int nb, int n_layers, int layer,
                                 int n_split, int chunk, float scale, void* stream) {
  if (bh == 0) return 0;
  const Geometry G{bh, g, d, m, K, n_heads, blk, nb, n_layers, layer, n_split, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_code == 0)
    return split_q<__nv_bfloat16>(idx_code, q, kcb, vcb, kpool, vpool, tables, length, part_acc,
                                  part_stat, G, scale, s);
  if (q_code == 1)
    return split_q<float>(idx_code, q, kcb, vcb, kpool, vpool, tables, length, part_acc,
                          part_stat, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Step 2: the partials of step 1 -> out (BH, g, d) and stats (BH, 2, g) f32.
int pq_decode_paged_merge_launch(const float* part_acc, const float* part_stat, float* out,
                                 float* stats, int bh, int g, int d, int n_split, void* stream) {
  if (bh == 0 || g == 0) return 0;
  return pqs::launch_merge(part_acc, part_stat, out, stats, bh, g, d, n_split,
                           static_cast<cudaStream_t>(stream));
}

// Both steps, one call: scratch holds part_acc (BH, S, g, d) then part_stat
// (BH, S, 2, g).
int pq_decode_paged_launch(int q_code, int idx_code, const void* q, const void* kcb,
                           const void* vcb, const void* kpool, const void* vpool,
                           const int* tables, const int* length, float* scratch, float* out,
                           float* stats, int bh, int g, int d, int m, int K, int n_heads,
                           int blk, int nb, int n_layers, int layer, int n_split, int chunk,
                           float scale, void* stream) {
  float* part_stat = scratch + (size_t)bh * n_split * g * d;
  int err = pq_decode_paged_split_launch(q_code, idx_code, q, kcb, vcb, kpool, vpool, tables,
                                         length, scratch, part_stat, bh, g, d, m, K, n_heads,
                                         blk, nb, n_layers, layer, n_split, chunk, scale, stream);
  if (err) return err;
  return pq_decode_paged_merge_launch(scratch, part_stat, out, stats, bh, g, d, n_split, stream);
}

}  // extern "C"
