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
//
// The device body lives in `pq_decode_body.cuh`, shared with K3
// (`pq_decode_paged.cu`); this file supplies the dense index-row addressing.
#include "pq_decode_body.cuh"

namespace {

// Index rows of a dense (BH, N, m) buffer; lengths per bh row.
template <typename IT>
struct DenseRows {
  const IT* idx;
  int n, m, capacity;
  __device__ __forceinline__ int length(const int* len, int bh) const { return len[bh]; }
  __device__ __forceinline__ const IT* row(int bh, int t) const {
    return idx + ((size_t)bh * n + t) * m;
  }
};

template <typename QT, typename IT>
int launch_dense(const void* q, const void* kcb, const void* vcb, const void* kidx,
                 const void* vidx, const int* length, float* out, float* stats, int bh,
                 int g, int d, int m, int K, int n, float scale, cudaStream_t stream) {
  const DenseRows<IT> kr{static_cast<const IT*>(kidx), n, m, n};
  const DenseRows<IT> vr{static_cast<const IT*>(vidx), n, m, n};
  return pqd::launch<QT, IT>(q, kcb, vcb, kr, vr, length, out, stats, bh, g, d, m, K,
                             scale, stream);
}

template <typename QT>
int launch_q(int idx_code, const void* q, const void* kcb, const void* vcb,
             const void* kidx, const void* vidx, const int* length, float* out,
             float* stats, int bh, int g, int d, int m, int K, int n, float scale,
             cudaStream_t stream) {
  switch (idx_code) {
    case 0:
      return launch_dense<QT, uint8_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh,
                                       g, d, m, K, n, scale, stream);
    case 1:
      return launch_dense<QT, int16_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh,
                                       g, d, m, K, n, scale, stream);
    case 2:
      return launch_dense<QT, int32_t>(q, kcb, vcb, kidx, vidx, length, out, stats, bh,
                                       g, d, m, K, n, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs; the wrapper refuses shapes over the
// card's per-block limit before launching.
size_t pq_decode_smem_bytes(int g, int d, int m, int k) {
  return pqd::smem_bytes(g, d, m, k);
}

int pq_decode_max_g() { return pqd::kMaxG; }
int pq_decode_max_outputs() { return pqd::kMaxOut * pqd::kThreads; }

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
