// Block-table-native GQA flash decode over packed K/V pools (K5),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_flash_decode.py::
// packed_paged_flash_decode_kernel` (body `_packed_paged_flash_decode_kernel`):
// for each (batch, kv head) row bh = b * H + h, the g query rows that share
// the kv head attend to the first length[b] cached tokens, read in place from
// the exact policy's packed resident store (`kernels/packing.py` block
// format).  Each of K and V is three pools: uint8 codes (P+1, L, H, blk,
// d*bits/8) and f16 scale and minimum (P+1, L, H, blk, G), one per group of
// `group` = d / G channels.  Token t of row bh lives in page
// tables[b, t / blk], plane `layer`, head h, row t % blk.  Every element is
// decoded on load:
//
//   bits 8: code = byte dim;
//   bits 4: split-half, code = low nibble of byte dim (dim < d/2) or high
//           nibble of byte dim - d/2;
//   bits 5: the bits-4 nibble plus, as bit 4, bit dim % 8 of byte
//           d/2 + dim / 8 (the fifth-bit plane, LSB first);
//
// and dequantized as f32(code) * f32(scale) + f32(min) with `__fmul_rn` and
// `__fadd_rn`, each rounded on its own, so nvcc's default contraction into an
// FMA cannot change a bit: the values are exactly those of the plain
// `packing.dequant_page`.  All arithmetic is f32 on the CUDA cores.  Output:
// the normalised (BH, g, d) f32 attention; length 0 gives 0.
//
// What bounds it on the H100: bytes, and fewer of them than K4's: a q4 row of
// d = 64 is 32 bytes of codes plus 2 * 2 * 2 bytes of headers against 128
// bytes of bf16.  The one-block-per-row design it had before (on K4's body,
// `flash_decode_body.cuh`) was bound by neither: 16 blocks at batch 4 left
// 116 of 132 SMs idle, and each element paid its own page lookup (a divide, a
// table read), byte load and two header loads.
//
// Design: K2's split over the sequence (`flash_decode.cu`), with the decode
// in the tile load.
//   1. `packed_split_kernel`, grid (BH, S): block (bh, s) takes the chunk
//      [s * chunk, (s + 1) * chunk) of row bh's tokens, cut at its length.
//      The wrapper picks S and the chunk (whole 64-token tiles) from the
//      capacity nb * blk and the SM count alone
//      (`paged_flash_decode.flash_decode_split`, K2's rule), never from the
//      device `length`, so the step stays free of host syncs.  For each tile
//      of 64 tokens, 64 threads resolve the tile's rows to their code and
//      header offsets once (one table read each); then each thread decodes
//      whole units of a row: 8 code bytes in one 8-byte load (16 elements of
//      q4 or q5, 8 of q8), their two (or one) header pairs read once, and
//      the fifth-bit bytes of q5 once, into f32 K and V tiles in shared
//      memory (rows padded by one float).  Scores, the online softmax and
//      the value contraction then run on those tiles as in K2's split
//      kernel, and the block writes its unnormalised partial (acc, max,
//      denom) to f32 scratch; a chunk at or past the length writes
//      (0, -inf, 0).
//   2. K2's merge kernel (`flash_decode_merge_launch` in `flash_decode.cu`,
//      called by the wrapper) combines the S partials of each query row in
//      chunk order.  No float atomics: two calls on the same inputs are
//      bit-equal.  Its sums run in another order than K4's single pass, so
//      on the f32 pools of the plain dequant K4 agrees within 1e-4, not bit
//      for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxOut = 8;  // (g*d) / kThreads outputs per thread: g*d <= 2048
constexpr int kUnit = 8;    // code bytes one thread decodes at a time
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

__device__ __forceinline__ float dequant(int code, float s, float m) {
  return __fadd_rn(__fmul_rn((float)code, s), m);
}

size_t smem_bytes(int g, int d) {
  size_t b = 0;
  b += 2 * (size_t)kTile * sizeof(unsigned long long);  // row offsets: codes, headers
  b += (size_t)g * d * sizeof(float);                   // q
  b += 2 * (size_t)kTile * (d + 1) * sizeof(float);     // k, v tiles (padded rows)
  b += (size_t)g * kTile * sizeof(float);               // scores / probabilities
  b += 3 * (size_t)g * sizeof(float);                   // max, denom, alpha
  return b;
}

// The six pools and the strides that find a row in them.
struct Pools {
  const uint8_t* pack[2];   // K, V codes (P+1, L, H, blk, dp)
  const __half* scale[2];   // K, V (P+1, L, H, blk, G)
  const __half* mn[2];
  unsigned long long pack_page, pack_layer;  // bytes of one page, and before plane `layer`
  unsigned long long hdr_page, hdr_layer;    // halves of one page, and before plane `layer`
  int dp, n_groups, group;
};

// kUnit code bytes at p: one 8-byte load (VEC: p 8-byte aligned) or bytes.
template <bool VEC>
__device__ __forceinline__ void load_unit(const uint8_t* p, uint8_t (&c)[kUnit]) {
  if constexpr (VEC) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = (v.x >> (8 * u)) & 0xFF;
      c[4 + u] = (v.y >> (8 * u)) & 0xFF;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnit; ++u) c[u] = p[u];
  }
}

// Decode unit j0 (a multiple of kUnit) of one packed row into dst (d f32).
// d is a multiple of 16 and the quant group (gcd(d, 32) in the store) a
// multiple of 8, so a unit's channels (and, for q4/q5, the high-nibble
// channels j0 + d/2 ...) lie in one group each and one fifth-bit byte each.
template <int BITS, bool VEC>
__device__ __forceinline__ void decode_unit(const uint8_t* row, const __half* sc, const __half* mn,
                                            int j0, int d, int group, float* dst) {
  uint8_t c[kUnit];
  load_unit<VEC>(row + j0, c);
  if constexpr (BITS == 8) {
    const int gi = j0 / group;
    const float s = __half2float(sc[gi]), m = __half2float(mn[gi]);
#pragma unroll
    for (int u = 0; u < kUnit; ++u) dst[j0 + u] = dequant(c[u], s, m);
  } else {
    const int half = d >> 1;
    const int glo = j0 / group, ghi = (j0 + half) / group;
    const float s_lo = __half2float(sc[glo]), m_lo = __half2float(mn[glo]);
    const float s_hi = __half2float(sc[ghi]), m_hi = __half2float(mn[ghi]);
    int f_lo = 0, f_hi = 0;
    if constexpr (BITS == 5) {
      f_lo = row[half + (j0 >> 3)];
      f_hi = row[half + ((j0 + half) >> 3)];
    }
#pragma unroll
    for (int u = 0; u < kUnit; ++u) {
      int lo = c[u] & 0xF, hi = c[u] >> 4;
      if constexpr (BITS == 5) {
        lo |= ((f_lo >> u) & 1) << 4;
        hi |= ((f_hi >> u) & 1) << 4;
      }
      dst[j0 + u] = dequant(lo, s_lo, m_lo);
      dst[half + j0 + u] = dequant(hi, s_hi, m_hi);
    }
  }
}

template <typename TQ, int BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
packed_split_kernel(const TQ* __restrict__ q, Pools pools, const int* __restrict__ tables,
                    const int* __restrict__ length, float* __restrict__ part_acc,
                    float* __restrict__ part_stat, int g, int d, int n_heads, int blk, int nb,
                    int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, s = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int ds = d + 1;

  unsigned long long* code_off = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* hdr_off = code_off + kTile;
  float* q_s = reinterpret_cast<float*>(hdr_off + kTile);
  float* k_s = q_s + g * d;
  float* v_s = k_s + kTile * ds;
  float* p_s = v_s + kTile * ds;
  float* mrun_s = p_s + g * kTile;
  float* lrun_s = mrun_s + g;
  float* alpha_s = lrun_s + g;

  const size_t part = (size_t)bh * n_split + s;
  float* acc_out = part_acc + part * g * d;
  float* stat_out = part_stat + part * 2 * g;  // (max[g], denom[g])
  const int len = min(max(length[b], 0), nb * blk);
  const int start = s * chunk, end = min(start + chunk, len);
  // units of kUnit code bytes in a row: the low-nibble half (q4, q5) or all
  const int upr = (BITS == 8 ? d : d / 2) / kUnit;

  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;
  if (start < end) {
    for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(q[(size_t)bh * g * d + i]);
    for (int i = tid; i < g; i += kThreads) {
      mrun_s[i] = -INFINITY;
      lrun_s[i] = 0.f;
    }
    const int* table = tables + (size_t)b * nb;
    for (int t0 = start; t0 < end; t0 += kTile) {
      const int nv = min(kTile, end - t0);
      __syncthreads();  // the previous tile is consumed (and q, stats visible)
      if (tid < nv) {
        const int t = t0 + tid, j = t / blk;
        const unsigned long long page = (unsigned long long)table[j];
        const unsigned long long prow = (unsigned long long)h * blk + (t - j * blk);
        code_off[tid] = page * pools.pack_page + pools.pack_layer + prow * pools.dp;
        hdr_off[tid] = page * pools.hdr_page + pools.hdr_layer + prow * pools.n_groups;
      }
      __syncthreads();
      const int units = nv * upr;
      for (int i = tid; i < 2 * units; i += kThreads) {
        const bool kv = i >= units;  // V's units follow K's
        const int ii = kv ? i - units : i;
        const int t = ii / upr, j0 = (ii - t * upr) * kUnit;
        decode_unit<BITS, VEC>((kv ? pools.pack[1] : pools.pack[0]) + code_off[t],
                               (kv ? pools.scale[1] : pools.scale[0]) + hdr_off[t],
                               (kv ? pools.mn[1] : pools.mn[0]) + hdr_off[t], j0, d,
                               pools.group, (kv ? v_s : k_s) + t * ds);
      }
      __syncthreads();

      // scores s[gi, t] = scale * <q[gi], k[t]>; a warp's lanes share gi
      for (int i = tid; i < g * kTile; i += kThreads) {
        const int gi = i / kTile, t = i - gi * kTile;
        float sc = -INFINITY;
        if (t < nv) {
          const float* qr = q_s + gi * d;
          const float* kr = k_s + t * ds;
          float a = 0.f;
          for (int e = 0; e < d; ++e) a = fmaf(qr[e], kr[e], a);
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
          for (int t = 0; t < nv; ++t) a = fmaf(pr[t], v_s[t * ds + dim], a);
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

template <typename TQ, int BITS>
int launch_split(const void* q, const Pools& pools, bool vec, const int* tables,
                 const int* length, float* part_acc, float* part_stat, int bh, int g, int d,
                 int n_heads, int blk, int nb, int n_split, int chunk, float scale,
                 cudaStream_t stream) {
  auto kern = vec ? packed_split_kernel<TQ, BITS, true> : packed_split_kernel<TQ, BITS, false>;
  const size_t smem = smem_bytes(g, d);
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(bh, n_split), kThreads, smem, stream>>>(static_cast<const TQ*>(q), pools, tables,
                                                      length, part_acc, part_stat, g, d,
                                                      n_heads, blk, nb, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_bits(int bits, const void* q, const Pools& pools, bool vec, const int* tables,
                const int* length, float* part_acc, float* part_stat, int bh, int g, int d,
                int n_heads, int blk, int nb, int n_split, int chunk, float scale,
                cudaStream_t s) {
  if (bits == 4)
    return launch_split<TQ, 4>(q, pools, vec, tables, length, part_acc, part_stat, bh, g, d,
                               n_heads, blk, nb, n_split, chunk, scale, s);
  if (bits == 5)
    return launch_split<TQ, 5>(q, pools, vec, tables, length, part_acc, part_stat, bh, g, d,
                               n_heads, blk, nb, n_split, chunk, scale, s);
  if (bits == 8)
    return launch_split<TQ, 8>(q, pools, vec, tables, length, part_acc, part_stat, bh, g, d,
                               n_heads, blk, nb, n_split, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t packed_paged_flash_decode_smem_bytes(int g, int d) { return smem_bytes(g, d); }

int packed_paged_flash_decode_max_outputs() { return kMaxOut * kThreads; }

// Step 1 (step 2 is K2's `flash_decode_merge_launch`).  dtype_code (of q):
// 0 = bf16, 1 = f32; bits 4, 5 or 8; d a multiple of 16 and groups of a
// multiple of 8 channels (else cudaErrorInvalidValue).  Pools in the order
// k_pack, k_scale, k_min, v_pack, v_scale, v_min; bh = B * n_heads rows;
// tables (B, nb) int32; length (B,) int32 -> part_acc (BH, S, g, d) and
// part_stat (BH, S, 2, g) f32, chunk tokens per split.  Returns
// cudaGetLastError() after the launch (0 on success).
int packed_paged_flash_decode_split_launch(
    int dtype_code, int bits, const void* q, const void* k_pack, const void* k_scale,
    const void* k_min, const void* v_pack, const void* v_scale, const void* v_min,
    const int* tables, const int* length, float* part_acc, float* part_stat, int bh, int g,
    int d, int n_heads, int blk, int nb, int n_layers, int layer, int n_groups, int n_split,
    int chunk, float scale, void* stream) {
  if (bh == 0) return 0;
  if (d % 16 || n_groups <= 0 || d % n_groups || (d / n_groups) % kUnit)
    return (int)cudaErrorInvalidValue;
  const int dp = d * bits / 8;
  const unsigned long long pack_plane = (unsigned long long)n_heads * blk * dp;
  const unsigned long long hdr_plane = (unsigned long long)n_heads * blk * n_groups;
  Pools pools;
  pools.pack[0] = static_cast<const uint8_t*>(k_pack);
  pools.pack[1] = static_cast<const uint8_t*>(v_pack);
  pools.scale[0] = static_cast<const __half*>(k_scale);
  pools.scale[1] = static_cast<const __half*>(v_scale);
  pools.mn[0] = static_cast<const __half*>(k_min);
  pools.mn[1] = static_cast<const __half*>(v_min);
  pools.pack_page = pack_plane * n_layers;
  pools.pack_layer = pack_plane * layer;
  pools.hdr_page = hdr_plane * n_layers;
  pools.hdr_layer = hdr_plane * layer;
  pools.dp = dp;
  pools.n_groups = n_groups;
  pools.group = d / n_groups;
  // 8-byte code loads where every row starts on 8 bytes
  const bool vec = dp % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k_pack) | reinterpret_cast<uintptr_t>(v_pack)) %
                    8) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_bits<__nv_bfloat16>(bits, q, pools, vec, tables, length, part_acc, part_stat,
                                      bh, g, d, n_heads, blk, nb, n_split, chunk, scale, s);
  if (dtype_code == 1)
    return launch_bits<float>(bits, q, pools, vec, tables, length, part_acc, part_stat, bh, g,
                              d, n_heads, blk, nb, n_split, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
