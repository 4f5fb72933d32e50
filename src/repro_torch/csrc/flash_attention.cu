// Blockwise causal (or full) flash attention forward (K7), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::
// flash_attention_kernel` (body `_flash_kernel`): for each (batch, query
// head h) and each query row, softmax(scale * q.K^T) V over the keys the row
// may see (all N keys, or keys at or before its own position when causal),
// with GQA: query head h reads kv head h / (Hq / Hkv).  The running (max,
// denom, acc) of each row are carried in f32 over the key tiles and the
// row's output is acc / max(denom, 1e-30), written in the input type.  The
// Pallas grid's sequential kv axis becomes a loop inside the block; the
// TPU kernel's `N % blk == 0` requirement does not hold here: a ragged last
// tile is masked (keys >= N score -inf and read as zeros, rows >= N are not
// written), so any N >= 1 works.
//
// What bounds it on the H100: operations, barely.  At the serving prefill
// (B 4, Hq 32, Hkv 4, N 1024, d 64, bf16, causal) one layer does
// 4 * B * Hq * d * N(N+1)/2 = 1.72e10 FLOP (QK^T and PV, FMA = 2) against
// 37,748,736 B of q, k, v and output: 0.0174 ms at 989 TFLOP/s (bf16 tensor
// cores) against 0.0113 ms at 3.35 TB/s; an engine admission (batch 1, the
// same N) is a quarter of both.  The design answers the operations
// side with the tensor cores and the bytes side by never writing the N x N
// scores: each block reads its K/V tiles once into shared memory and keeps
// scores, probabilities and the running statistics in registers.
//
// One block per (batch, query head, tile of 64 query rows), four warps of 16
// rows each; the last query tile runs first (causal tiles there do the most
// work).  Per key tile of 64:
//   1. all threads stage K (64 x d, rows padded by 16 B against bank
//      conflicts) and V, transposed to (d x 64), in shared memory; keys >= N
//      read as zeros; tiles wholly above the causal diagonal are skipped;
//   2. each warp computes its 16 x 64 scores S = Q K^T with
//      `mma.sync.m16n8k16` (bf16 in, f32 accumulate), Q's fragments held in
//      registers for the whole block;
//   3. scale, mask (key >= N, or key > row when causal) to -inf, and the
//      online softmax on the accumulator registers: the four threads that
//      share a row reduce its max and sum through two shuffles;
//   4. O += P V with `mma.sync` again: the score accumulators are re-used
//      as the A fragments of P (the C layout of two n-blocks is the A layout
//      of one k-block).  P is rounded to bf16 for this product (the row sum
//      is taken from the f32 values), so against the plain version's f32 P
//      each output may move by up to 2^-8 x the attention of |v|, plus one
//      bf16 rounding of the output: `flash_attention.kernel_error_bound`,
//      which `chip_smoke.py` and the card tests hold the kernel to (1.56e-2
//      max abs error at the serving shapes on an H100, 0.72 of the bound).
//
// f32 inputs take the same block, tiles and softmax with the products on
// the CUDA cores (FMA, no TF32): Q and the warp's P rows are staged in
// shared memory and each thread computes its accumulator positions of the
// mma layout itself.  That path is for exactness, not speed.
//
// Sharing each K/V tile across the g query heads of a kv head, and
// overlapping the tile loads with the products, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;  // query rows per block
constexpr int kTileK = 64;           // keys per tile
constexpr int kNB = kTileK / 8;      // n-blocks of 8 keys in a score tile

template <int D, typename T>
struct Layout {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  // K tile (kTileK, kKStride): 16 B of padding per row
  static constexpr int kKStride = D + 16 / (int)sizeof(T);
  // V tile: transposed (D, kTileK + 8) for the mma path, (kTileK, D + 4) else
  static constexpr int kVRows = kMma ? D : kTileK;
  static constexpr int kVStride = kMma ? kTileK + 8 : D + 4;
  static constexpr size_t kTileBytes =
      sizeof(T) * ((size_t)kTileK * kKStride + (size_t)kVRows * kVStride);
  // f32 path only: Q tile (kTileQ, kKStride) and each warp's P (16, kTileK + 4)
  static constexpr int kPStride = kTileK + 4;
  static constexpr size_t kBytes =
      kTileBytes + (kMma ? 0
                         : sizeof(float) * ((size_t)kTileQ * kKStride +
                                            (size_t)kWarps * 16 * kPStride));
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent bf16 of row `row` at column `col` (even), zero past the end.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col, int n,
                                              int d) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv, int n,
                       float scale) {
  using L = Layout<D, T>;
  constexpr int kDB = D / 8;            // n-blocks of 8 output dims
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTileK * L::kKStride;

  const int n_qt = (n + kTileQ - 1) / kTileQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qb = q + ((size_t)b * hq + h) * n * D;
  const T* kb = k + ((size_t)b * hkv + hk) * n * D;
  const T* vb = v + ((size_t)b * hkv + hk) * n * D;
  T* ob = out + ((size_t)b * hq + h) * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTileQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  float acc[kDB][4];
#pragma unroll
  for (int j = 0; j < kDB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Q: mma A fragments in registers (bf16), or the tile in shared memory (f32)
  uint32_t qf[L::kMma ? D / 16 : 1][4];
  float* qs = nullptr;
  float* ps = nullptr;
  if constexpr (L::kMma) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int col = kc * 16 + 2 * t;
      qf[kc][0] = load_pair(qb, r0, col, n, D);
      qf[kc][1] = load_pair(qb, r1, col, n, D);
      qf[kc][2] = load_pair(qb, r0, col + 8, n, D);
      qf[kc][3] = load_pair(qb, r1, col + 8, n, D);
    }
  } else {
    qs = reinterpret_cast<float*>(smem_raw + L::kTileBytes);
    ps = qs + kTileQ * L::kKStride + warp * 16 * L::kPStride;
    for (int i = threadIdx.x; i < kTileQ * D; i += kThreads) {
      const int row = i / D, c = i % D;
      qs[row * L::kKStride + c] = (q0 + row < n) ? (float)qb[(size_t)(q0 + row) * D + c] : 0.f;
    }
  }

  const int n_kt_all = (n + kTileK - 1) / kTileK;
  const int n_kt = CAUSAL ? min(n_kt_all, (q0 + kTileQ - 1) / kTileK + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + row < n) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * D + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + row * L::kKStride + c) = kv4;
      if constexpr (L::kMma) {
        const T* ve = reinterpret_cast<const T*>(&vv4);
#pragma unroll
        for (int e = 0; e < kVec; ++e) vs[(c + e) * L::kVStride + row] = ve[e];
      } else {
        *reinterpret_cast<uint4*>(vs + row * L::kVStride + c) = vv4;
      }
    }
    __syncthreads();

    // S = Q K^T: s[j] holds rows (g, g+8) x keys 8j + 2t + (0, 1)
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (L::kMma) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const T* krow = ks + (8 * j + g) * L::kKStride + 2 * t;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kc * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8);
          mma_bf16(s[j], qf[kc], b0, b1);
        }
      }
    } else {
      const float* qa = qs + (warp * 16 + g) * L::kKStride;
      const float* qc = qa + 8 * L::kKStride;
      for (int e = 0; e < D; ++e) {
        const float x0 = qa[e], x1 = qc[e];
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float kvv = (float)ks[(8 * j + 2 * t + c) * L::kKStride + e];
            s[j][c] = fmaf(x0, kvv, s[j][c]);
            s[j][2 + c] = fmaf(x1, kvv, s[j][2 + c]);
          }
        }
      }
    }

    // scale and mask, then the online softmax per row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * t + (c & 1);
        const int row = c < 2 ? r0 : r1;
        const bool ok = key < n && (!CAUSAL || key <= row);
        s[j][c] = ok ? s[j][c] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with no visible key yet keeps max -inf: subtract 0 instead
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = expf(m0 - base0), alpha1 = expf(m1 - base1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      s[j][0] = expf(s[j][0] - base0);
      s[j][1] = expf(s[j][1] - base0);
      s[j][2] = expf(s[j][2] - base1);
      s[j][3] = expf(s[j][3] - base1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int j = 0; j < kDB; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // O += P V
    if constexpr (L::kMma) {
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kDB; ++j) {
          const T* vrow = vs + (8 * j + g) * L::kVStride + kk * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
          mma_bf16(acc[j], a, b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        ps[g * L::kPStride + 8 * j + 2 * t] = s[j][0];
        ps[g * L::kPStride + 8 * j + 2 * t + 1] = s[j][1];
        ps[(g + 8) * L::kPStride + 8 * j + 2 * t] = s[j][2];
        ps[(g + 8) * L::kPStride + 8 * j + 2 * t + 1] = s[j][3];
      }
      __syncwarp();
      for (int key = 0; key < kTileK; ++key) {
        const float p0 = ps[g * L::kPStride + key], p1 = ps[(g + 8) * L::kPStride + key];
#pragma unroll
        for (int j = 0; j < kDB; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float vv = (float)vs[key * L::kVStride + 8 * j + 2 * t + c];
            acc[j][c] = fmaf(p0, vv, acc[j][c]);
            acc[j][2 + c] = fmaf(p1, vv, acc[j][2 + c]);
          }
        }
      }
      __syncwarp();
    }
  }

  // acc / max(denom, 1e-30), in the input type
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDB; ++j) {
    const int col = 8 * j + 2 * t;
    if constexpr (L::kMma) {
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
            pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
            pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
    } else {
      if (r0 < n)
        *reinterpret_cast<float2*>(ob + (size_t)r0 * D + col) =
            make_float2(acc[j][0] / d0, acc[j][1] / d0);
      if (r1 < n)
        *reinterpret_cast<float2*>(ob + (size_t)r1 * D + col) =
            make_float2(acc[j][2] / d1, acc[j][3] / d1);
    }
  }
}

template <int D, typename T, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int n, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D, T, CAUSAL>;
  const size_t smem = Layout<D, T>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTileQ - 1) / kTileQ, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), hq,
                                         hkv, n, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int launch_d(int d, const void* q, const void* k, const void* v, void* out, int b, int hq,
             int hkv, int n, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 32: return launch<32, T, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 64: return launch<64, T, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 128: return launch<128, T, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_d(int d) {
  switch (d) {
    case 16: return Layout<16, T>::kBytes;
    case 32: return Layout<32, T>::kBytes;
    case 64: return Layout<64, T>::kBytes;
    case 128: return Layout<128, T>::kBytes;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = bf16, 1 = f32.  0 for a head dim the kernel does not take.
size_t flash_attention_smem_bytes(int dtype_code, int d) {
  return dtype_code == 0 ? smem_d<__nv_bfloat16>(d) : smem_d<float>(d);
}

// q (B, Hq, N, d), k and v (B, Hkv, N, d), out (B, Hq, N, d), all contiguous
// in one type (dtype_code 0 = bf16, 1 = f32), 16-byte aligned; d in {16, 32,
// 64, 128}; Hq a multiple of Hkv.  Returns cudaGetLastError() after the
// launch (0 on success).
int flash_attention_launch(int dtype_code, int causal, const void* q, const void* k,
                           const void* v, void* out, int b, int hq, int hkv, int n, int d,
                           float scale, void* stream) {
  if (b == 0 || hq == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return causal ? launch_d<__nv_bfloat16, true>(d, q, k, v, out, b, hq, hkv, n, scale, s)
                  : launch_d<__nv_bfloat16, false>(d, q, k, v, out, b, hq, hkv, n, scale, s);
  if (dtype_code == 1)
    return causal ? launch_d<float, true>(d, q, k, v, out, b, hq, hkv, n, scale, s)
                  : launch_d<float, false>(d, q, k, v, out, b, hq, hkv, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
