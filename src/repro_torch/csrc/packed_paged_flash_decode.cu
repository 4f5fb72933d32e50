// Block-table-native GQA flash decode over packed K/V pools (K5),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/paged_flash_decode.py::
// packed_paged_flash_decode_kernel` (body `_packed_paged_flash_decode_kernel`):
// K4's function (see `paged_flash_decode.cu`) over the exact policy's packed
// resident store (`kernels/packing.py` block format).  Each of K and V is
// three pools: uint8 codes (P+1, L, H, blk, d*bits/8) and f16 scale and
// minimum (P+1, L, H, blk, G), one per group of `group` = d / G channels.
// Token t of row bh = b * H + h lives in page tables[b, t / blk], plane
// `layer`, head h, row t % blk.  Every element is decoded on load:
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
// `packing.dequant_page`, and on them K4 gives the same output bits.
// Output: the normalised (BH, g, d) f32 attention; length 0 gives 0.
//
// What bounds it on the H100: bytes, as for K4, and fewer of them: a q4
// row of d = 64 is 32 bytes of codes plus 2 * 2 * 2 bytes of headers against
// 128 bytes of bf16.  The design is K4's, through the shared device body
// (`flash_decode_body.cuh`): the decode replaces the element load of the
// K/V tile, so the scores, the online softmax and the value contraction
// run on the same f32 tile in shared memory.  The bit width is a template
// parameter, so each kernel carries one decode.
#include <cuda_fp16.h>

#include "flash_decode_body.cuh"

namespace {

// K or V elements of packed pools through tables (B, nb); lengths per
// request b = bh / H.
template <int BITS>
struct PackedRows {
  const uint8_t* pack;   // (P+1, L, H, blk, dp)
  const __half* scale;   // (P+1, L, H, blk, G)
  const __half* mn;
  const int* tables;
  int nb, n_heads, blk, d, dp, n_groups, group, capacity;
  size_t pack_page, pack_layer;  // bytes of one page, and before plane `layer`
  size_t hdr_page, hdr_layer;    // halves of one page, and before plane `layer`
  __device__ __forceinline__ int length(const int* len, int bh) const {
    return len[bh / n_heads];
  }
  __device__ __forceinline__ float value(int bh, int t, int dim) const {
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int j = t / blk;
    const size_t page = (size_t)tables[(size_t)b * nb + j];
    const size_t prow = (size_t)h * blk + (t - j * blk);
    const uint8_t* p = pack + page * pack_page + pack_layer + prow * dp;
    int code;
    if (BITS == 8) {
      code = p[dim];
    } else {
      const int half = d >> 1;
      const int byte = p[dim < half ? dim : dim - half];
      code = dim < half ? (byte & 0xF) : (byte >> 4);
      if (BITS == 5) code |= ((p[half + (dim >> 3)] >> (dim & 7)) & 1) << 4;
    }
    const size_t hi = page * hdr_page + hdr_layer + prow * n_groups + dim / group;
    return __fadd_rn(__fmul_rn((float)code, __half2float(scale[hi])),
                     __half2float(mn[hi]));
  }
};

template <typename TQ, int BITS>
int launch_packed(const void* q, const void* const* pools, const int* tables,
                  const int* length, float* out, int bh, int g, int d, int n_heads,
                  int blk, int nb, int n_layers, int layer, int n_groups, float scale,
                  cudaStream_t stream) {
  const int dp = d * BITS / 8;
  const size_t pack_plane = (size_t)n_heads * blk * dp;
  const size_t hdr_plane = (size_t)n_heads * blk * n_groups;
  auto rows = [&](int i) {
    return PackedRows<BITS>{static_cast<const uint8_t*>(pools[3 * i]),
                            static_cast<const __half*>(pools[3 * i + 1]),
                            static_cast<const __half*>(pools[3 * i + 2]),
                            tables, nb, n_heads, blk, d, dp, n_groups, d / n_groups,
                            nb * blk, pack_plane * n_layers, pack_plane * layer,
                            hdr_plane * n_layers, hdr_plane * layer};
  };
  return fdk::launch<TQ>(q, rows(0), rows(1), length, out, bh, g, d, scale, stream);
}

template <typename TQ>
int launch_bits(int bits, const void* q, const void* const* pools, const int* tables,
                const int* length, float* out, int bh, int g, int d, int n_heads,
                int blk, int nb, int n_layers, int layer, int n_groups, float scale,
                cudaStream_t s) {
  if (bits == 4)
    return launch_packed<TQ, 4>(q, pools, tables, length, out, bh, g, d, n_heads, blk,
                                nb, n_layers, layer, n_groups, scale, s);
  if (bits == 5)
    return launch_packed<TQ, 5>(q, pools, tables, length, out, bh, g, d, n_heads, blk,
                                nb, n_layers, layer, n_groups, scale, s);
  if (bits == 8)
    return launch_packed<TQ, 8>(q, pools, tables, length, out, bh, g, d, n_heads, blk,
                                nb, n_layers, layer, n_groups, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t packed_paged_flash_decode_smem_bytes(int g, int d) { return fdk::smem_bytes(g, d); }

int packed_paged_flash_decode_max_outputs() { return fdk::kMaxOut * fdk::kThreads; }

// dtype_code (of q): 0 = bf16, 1 = f32; bits 4, 5 or 8.  Pools in the
// order k_pack, k_scale, k_min, v_pack, v_scale, v_min; bh = B * n_heads
// rows; tables (B, nb) int32; length (B,) int32.  Returns cudaGetLastError()
// after the launch (0 on success).
int packed_paged_flash_decode_launch(int dtype_code, int bits, const void* q,
                                     const void* k_pack, const void* k_scale,
                                     const void* k_min, const void* v_pack,
                                     const void* v_scale, const void* v_min,
                                     const int* tables, const int* length, float* out,
                                     int bh, int g, int d, int n_heads, int blk, int nb,
                                     int n_layers, int layer, int n_groups, float scale,
                                     void* stream) {
  if (bh == 0) return 0;
  const void* pools[6] = {k_pack, k_scale, k_min, v_pack, v_scale, v_min};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_bits<__nv_bfloat16>(bits, q, pools, tables, length, out, bh, g, d,
                                      n_heads, blk, nb, n_layers, layer, n_groups, scale,
                                      s);
  if (dtype_code == 1)
    return launch_bits<float>(bits, q, pools, tables, length, out, bh, g, d, n_heads,
                              blk, nb, n_layers, layer, n_groups, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
