// Blockwise causal (or full) flash attention forward (K7), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::
// flash_attention_kernel` (body `_flash_kernel`): for each (batch, query
// head h) and each query row, softmax(scale * q.K^T) V over the keys the row
// may see (all N keys, or keys at or before its own position when causal),
// with GQA: query head h reads kv head h / (Hq / Hkv).  The row's output is
// acc / max(denom, 1e-30), written in the input type.  The Pallas grid's
// sequential kv axis becomes a loop inside the block; the TPU kernel's
// `N % blk == 0` requirement does not hold here: a ragged last tile is
// masked (keys >= N score -inf and read as zeros, rows >= N are not
// written), so any N >= 1 works.
//
// What bounds it on the H100: operations.  At the serving prefill (B 4,
// Hq 32, Hkv 4, N 1024, d 64, bf16, causal) one layer does
// 4 * B * Hq * d * N(N+1)/2 = 1.72e10 FLOP (QK^T and PV, FMA = 2) against
// 37,748,736 B of q, k, v and output: 0.0174 ms at 989 TFLOP/s (bf16 tensor
// cores) against 0.0113 ms at 3.35 TB/s.  At d = 64 the softmax's exp2 is a
// second roof of the same height: one exp per score against 4d = 256 FLOP
// of products, and the SM's 16 MUFU results per clock against its 4096
// tensor FLOP per clock.  No N x N score ever reaches device memory.
//
// bf16 design (both bodies below share it):
//   - One block per (batch, kv head, group of hb query heads of that kv
//     head, tile of pt query positions), hb * pt rows: 64 at d = 64, 128
//     elsewhere; hb is the largest of 8, 4, 2, 1 that divides g = Hq / Hkv
//     and fits (`flash_attention.block_geometry`).  At g = 8 and d = 64 a
//     block holds 16 positions of 4 heads, so each K/V tile goes from device
//     memory to shared memory twice per group of 8 heads, not 8 times.  Each
//     warp owns 16-row m-tiles of one head; the causal skip and the diagonal
//     mask depend on the position only.
//   - Grid (B * Hq / hb, N / pt): position tiles on the slow axis, last tile
//     first, so the heaviest causal blocks of every head start first.
//   - A ring of K/V tiles (64 keys) in shared memory, filled by
//     `cp.async.cg` 16-byte copies ahead of their use; keys >= N are
//     zero-filled (src-size 0), as V garbage times P = 0 would give NaN.
//     Rows are stored in place (K and V row-major) with 16-byte chunks
//     XOR-swizzled by row: the hardware's 128-byte swizzle at d = 64, and
//     free of bank conflicts for the fragment reads at every d.
//   - Softmax on the raw scores: exp2(sl2 s - sl2 m) with sl2 = scale *
//     log2(e) (one FFMA and one `ex2` per score); a negative scale flips Q's
//     sign instead.  The reference max m of a row moves only when the
//     warp sees a max 8 (log2 units) above it, so most tiles skip the
//     rescale of the accumulators.  The row sum is taken from the f32 P, and
//     P is rounded to bf16 for PV: against the plain version's f32 P each
//     output may move by up to 2^-8 x the attention of |v|, plus one bf16
//     rounding of the output: `flash_attention.kernel_error_bound`, which
//     `chip_smoke.py` and the card tests hold the kernel to.
//   - d = 64 (the served models' head dim): `wgmma.m64n64k16`, one
//     warpgroup of 64 rows per block, four blocks per SM, three ring stages.
//     Q's A fragments stay in registers; S = Q K^T reads K from shared
//     memory by descriptor (K-major, 128-byte swizzle); P is re-packed from
//     the S accumulators as the A fragments of O += P V, whose B operand is
//     V read in place (MN-major, transposed by the descriptor).  S of tile
//     kt+1 and PV of tile kt run on the tensor cores while the softmax of
//     tile kt+1 runs.
//   - d = 16, 32, 128: `mma.sync.m16n8k16` with `ldmatrix.x4` (K) and
//     `ldmatrix.x4.trans` (V) fragments, eight warps and two ring stages;
//     two m-tiles per warp where the registers allow (d <= 64), so each
//     fragment read feeds two products.
//
// f32 inputs take their own block (unchanged from the first port): one
// query head and 64 rows per block, synchronous padded tile loads, the
// products on the CUDA cores (FMA, no TF32).  That path is for exactness,
// not speed.
//
// Left for later (`tools/k7_floors.py`, PERF.md): with no softmax and no
// tile loads at all the d = 64 body still runs at about half the tensor
// cores' rate, so the product pipeline itself (one warpgroup, 64-key tiles,
// a full wait for PV and a block barrier per tile) holds it near SDPA.
// Feeding the ring by TMA instead of cp.async did not make it faster; what
// is left is a deeper asynchronous pipeline (more stages, P double-buffered,
// no drain per tile) and two consumer warpgroups in ping-pong.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;           // keys per tile
constexpr int kNB = kTileK / 8;      // n-blocks of 8 keys in a score tile
constexpr int kMmaRows = 128;        // (head, position) rows per mma.sync block
constexpr int kWgRows = 64;          // ... per wgmma block (d = 64)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !full (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two adjacent bf16 of row `row` at column `col` (even), zero past the end.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col, int n,
                                              int d) {
  if (row >= n) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

// ---------------------------------------------------------------------------
// bf16 blocks: geometry, tile ring, softmax (shared by both bodies)
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c of row r in a tile of D bf16 per row: the
// chunk index is XORed with bits of the row so that 8 consecutive rows at one
// logical chunk fall into 8 distinct bank groups.  At D = 64 (128-byte rows)
// this is the hardware's 128-byte swizzle on a 1024-byte-aligned tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kCpr = D / 8;  // chunks per row
  if constexpr (kCpr >= 8) {
    return r * kCpr * 16 + ((c ^ (r & 7)) << 4);
  } else {
    return r * kCpr * 16 + ((c ^ ((r / (8 / kCpr)) & (kCpr - 1))) << 4);
  }
}

// Where a bf16 block sits and which rows its m-tiles hold.
struct Block {
  int b, kvh, h0;  // batch, kv head, first query head of the block
  int q0, pt;      // first position, positions per block
  int n_kt;        // key tiles the block visits
  int g, hq;

  __device__ __forceinline__ Block(int hq_, int hkv, int n, int hb, bool causal,
                                   int rows) {
    hq = hq_;
    g = hq / hkv;
    pt = rows / hb;
    const int ngrp = g / hb;
    const int x = blockIdx.x;
    const int grp = x % ngrp;
    kvh = (x / ngrp) % hkv;
    b = x / (ngrp * hkv);
    h0 = kvh * g + grp * hb;
    const int n_pt = (n + pt - 1) / pt;
    q0 = (n_pt - 1 - (int)blockIdx.y) * pt;
    const int n_kt_all = (n + kTileK - 1) / kTileK;
    n_kt = causal ? min(n_kt_all, (min(q0 + pt, n) - 1) / kTileK + 1) : n_kt_all;
  }
  // m-tile f (0..7): its query head and first position
  __device__ __forceinline__ int head(int f) const { return h0 + f / (pt / 16); }
  __device__ __forceinline__ int pos(int f) const { return q0 + (f % (pt / 16)) * 16; }
};

// 16 bytes global -> shared, the whole chunk valid
__device__ __forceinline__ void cp_async16_full(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// The cp.async copies of a key tile (K and V, 64 rows of D bf16) into a ring
// stage.  Each thread owns one 16-byte chunk column c and the rows r0 + j *
// kRowStep: its global and shared offsets are set once per block, and the
// swizzle term c ^ f(row) is the same for all of its rows.
template <int D, int NT>
struct TileLoader {
  static constexpr int kCpr = D / 8;  // chunks per row
  static constexpr int kRowStep = NT / kCpr;
  static constexpr int kIters = kTileK / kRowStep;
  static_assert(NT % kCpr == 0 && kTileK % kRowStep == 0, "threads must tile the K/V tile");
  int r0, goff;
  uint32_t soff;

  __device__ __forceinline__ TileLoader()
      : r0(threadIdx.x / kCpr),
        goff(threadIdx.x / kCpr * D + threadIdx.x % kCpr * 8),
        soff(swz<D>(threadIdx.x / kCpr, threadIdx.x % kCpr)) {}

  // K and V of key tile kt into the tiles at ks and vs
  __device__ __forceinline__ void operator()(uint32_t ks, uint32_t vs, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, int kt, int n) const {
    const int k0 = kt * kTileK;
    const __nv_bfloat16* kp = kb + (size_t)k0 * D + goff;
    const __nv_bfloat16* vp = vb + (size_t)k0 * D + goff;
    if (k0 + kTileK <= n) {
#pragma unroll
      for (int j = 0; j < kIters; ++j) {
        cp_async16_full(ks + soff + j * kRowStep * D * 2, kp + j * kRowStep * D);
        cp_async16_full(vs + soff + j * kRowStep * D * 2, vp + j * kRowStep * D);
      }
    } else {
      // keys >= n read as zeros (src-size 0; the source address stays valid)
#pragma unroll
      for (int j = 0; j < kIters; ++j) {
        const bool ok = k0 + r0 + j * kRowStep < n;
        cp_async16(ks + soff + j * kRowStep * D * 2, ok ? kp + j * kRowStep * D : kb, ok);
        cp_async16(vs + soff + j * kRowStep * D * 2, ok ? vp + j * kRowStep * D : vb, ok);
      }
    }
  }
};

// The running statistics of a thread's two rows (g and g + 8 of an m-tile):
// the reference max of the raw scores q.k, and this thread's share of the
// denom (the four threads of a row are summed at the end).
struct Rows2 {
  float m0, m1, l0, l1;
};

// Mask one 16 x 64 raw score tile and turn it into P = exp2(sl2 s - sl2 m)
// in place (sl2 = scale * log2(e) > 0: the kernels flip Q's sign for a
// negative scale).  The reference max m of a row moves only when some row of
// the warp sees a max more than kLazy (log2 units) above its own, so P stays
// below 2^kLazy and the accumulators are rescaled, by alpha, only then
// (`resc`, warp-uniform).  acc / denom is the same function as with the
// running max; P's bf16 rounding stays relative.
constexpr float kLazy = 8.f;

template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[kNB][4], Rows2& st, float& alpha0,
                                                  float& alpha1, bool& resc, bool mask, int k0,
                                                  int r0, int n, float sl2) {
  const int t = threadIdx.x & 3;
  if (mask) {
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * t + (c & 1);
        const int row = c < 2 ? r0 : r0 + 8;
        if (!(key < n && (!CAUSAL || key <= row))) s[j][c] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // -inf - -inf is NaN and compares false: a row with nothing visible yet
  // does not ask for a rescale
  resc = __any_sync(0xffffffffu, (mx0 - st.m0) * sl2 > kLazy || (mx1 - st.m1) * sl2 > kLazy);
  alpha0 = alpha1 = 1.f;
  if (resc) {
    const float n0 = fmaxf(st.m0, mx0), n1 = fmaxf(st.m1, mx1);
    alpha0 = st.m0 == -INFINITY ? 0.f : ex2((st.m0 - n0) * sl2);
    alpha1 = st.m1 == -INFINITY ? 0.f : ex2((st.m1 - n1) * sl2);
    st.m0 = n0;
    st.m1 = n1;
    st.l0 *= alpha0;
    st.l1 *= alpha1;
  }
  const float base0 = st.m0 == -INFINITY ? 0.f : st.m0 * sl2;
  const float base1 = st.m1 == -INFINITY ? 0.f : st.m1 * sl2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], sl2, -base0));
    s[j][1] = ex2(fmaf(s[j][1], sl2, -base0));
    s[j][2] = ex2(fmaf(s[j][2], sl2, -base1));
    s[j][3] = ex2(fmaf(s[j][3], sl2, -base1));
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
  st.l0 += rs0;
  st.l1 += rs1;
}

// P (16 x 64, f32 accumulator layout) as the bf16 A fragments of 4 k-steps
// of 16 keys
__device__ __forceinline__ void pack_p(uint32_t (&a)[kNB / 2][4], const float (&s)[kNB][4]) {
#pragma unroll
  for (int kk = 0; kk < kNB / 2; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc / max(denom, 1e-30) for the thread's two rows of an m-tile, in bf16;
// rows >= n are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, const float (&acc)[D / 8][4],
                                           Rows2 st, int r0, int n) {
  const int t = threadIdx.x & 3;
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
  const float d0 = fmaxf(st.l0, 1e-30f), d1 = fmaxf(st.l1, 1e-30f);
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
}

// Q's A fragments of one m-tile (head h, rows r0 and r0 + 8), zero past n;
// `neg` flips their signs (exact in bf16) so that a negative scale enters
// the softmax as a positive one.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], const __nv_bfloat16* q, int b,
                                       int hq, int h, int r0, int n, bool neg) {
  const int t = threadIdx.x & 3;
  const __nv_bfloat16* qb = q + ((size_t)b * hq + h) * n * D;
  const uint32_t flip = neg ? 0x80008000u : 0u;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int col = kc * 16 + 2 * t;
    qf[kc][0] = load_pair(qb, r0, col, n, D) ^ flip;
    qf[kc][1] = load_pair(qb, r0 + 8, col, n, D) ^ flip;
    qf[kc][2] = load_pair(qb, r0, col + 8, n, D) ^ flip;
    qf[kc][3] = load_pair(qb, r0 + 8, col + 8, n, D) ^ flip;
  }
}

// ---------------------------------------------------------------------------
// bf16, d in {16, 32, 128}: mma.sync with ldmatrix fragments
// ---------------------------------------------------------------------------

template <int D>
struct MmaCfg {
  static constexpr int kMT = D <= 64 ? 2 : 1;  // m-tiles per warp
  static constexpr int kWarps = 8 / kMT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileBytes = kTileK * D * 2;
  static constexpr size_t kSmem = 4 * (size_t)kTileBytes;  // 2 stages x (K, V)
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(MmaCfg<D>::kThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           int hq, int hkv, int n, int hb, float sl2_signed) {
  using C = MmaCfg<D>;
  const float sl2 = fmaxf(fabsf(sl2_signed), 1.17549435e-38f);  // > 0: -inf * sl2 = -inf
  constexpr int MT = C::kMT;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sbase = smem_u32(smem_mma);

  const Block blk(hq, hkv, n, hb, CAUSAL, kMmaRows);
  const __nv_bfloat16* kb = k + ((size_t)blk.b * hkv + blk.kvh) * n * D;
  const __nv_bfloat16* vb = v + ((size_t)blk.b * hkv + blk.kvh) * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2;

  uint32_t qf[MT][D / 16][4];
  float acc[MT][D / 8][4];
  Rows2 st[MT];
  int r0[MT];
  int last_row = 0;  // the warp's last position: key tiles past it are skipped
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int f = warp * MT + mt;
    r0[mt] = blk.pos(f) + gq;
    last_row = max(last_row, blk.pos(f) + 15);
    load_q<D>(qf[mt], q, blk.b, hq, blk.head(f), r0[mt], n, sl2_signed < 0.f);
    st[mt] = Rows2{-INFINITY, -INFINITY, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  const TileLoader<D, C::kThreads> load_tile;
  load_tile(sbase, sbase + C::kTileBytes, kb, vb, 0, n);
  cp_async_commit();
  for (int kt = 0; kt < blk.n_kt; ++kt) {
    if (kt + 1 < blk.n_kt) {
      const uint32_t nxt = sbase + ((kt + 1) & 1) * 2 * C::kTileBytes;
      load_tile(nxt, nxt + C::kTileBytes, kb, vb, kt + 1, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kTileK;
    const uint32_t ks = sbase + (kt & 1) * 2 * C::kTileBytes;
    const uint32_t vs = ks + C::kTileBytes;
    if (!CAUSAL || k0 <= last_row) {
      // S = Q K^T: B fragments of two n-blocks per ldmatrix.x4
      float s[MT][kNB][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kNB; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
        for (int jp = 0; jp < kNB / 2; ++jp) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + swz<D>(16 * jp + 8 * (lane >> 4) + (lane & 7), 2 * kc + ((lane >> 3) & 1)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jp], qf[mt][kc], bf[0], bf[1]);
            mma_bf16(s[mt][2 * jp + 1], qf[mt][kc], bf[2], bf[3]);
          }
        }
      }
      uint32_t pa[MT][kTileK / 16][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int first = r0[mt] - gq;
        const bool mask = k0 + kTileK > n || (CAUSAL && k0 + kTileK - 1 > first);
        float a0, a1;
        bool resc;
        softmax_tile<CAUSAL>(s[mt], st[mt], a0, a1, resc, mask, k0, r0[mt], n, sl2);
        if (resc) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[mt][j][0] *= a0;
            acc[mt][j][1] *= a0;
            acc[mt][j][2] *= a1;
            acc[mt][j][3] *= a1;
          }
        }
        pack_p(pa[mt], s[mt]);
      }
      // O += P V: B fragments of two d-blocks per ldmatrix.x4.trans
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vs + swz<D>(16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7), 2 * jp + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * jp], pa[mt][kk], bf[0], bf[1]);
            mma_bf16(acc[mt][2 * jp + 1], pa[mt][kk], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before tile kt + 2 refills it
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int f = warp * MT + mt;
    store_rows<D>(out + ((size_t)blk.b * hq + blk.head(f)) * n * D, acc[mt], st[mt], r0[mt], n);
  }
}

// ---------------------------------------------------------------------------
// bf16, d = 64: wgmma, K and V read from shared memory by descriptor
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;         // one warpgroup of 64 rows
constexpr int kWgTileBytes = kTileK * 64 * 2;
constexpr int kWgStages = 3;            // ring of (K, V) tile pairs
constexpr int kWgStageBytes = 2 * kWgTileBytes;
constexpr size_t kWgSmem = kWgStages * (size_t)kWgStageBytes + 1024;  // + alignment slack

// Shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024 B
// apart (stride byte offset); the leading byte offset is unused for these
// one-atom-wide tiles.  Adding (byte offset >> 4) moves it within the tile.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (1ull << 62) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 16) |
         (uint64_t)((addr >> 4) & 0x3FFF);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[kNB][4]) {
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
}

// rows g and g + 8 of an m-tile's accumulator times their alpha
__device__ __forceinline__ void rescale(float (&acc)[kNB][4], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    acc[j][0] *= a0;
    acc[j][1] *= a0;
    acc[j][2] *= a1;
    acc[j][3] *= a1;
  }
}

// d (64 x 64, f32, per warp its 16 rows in the mma.sync C layout) (+)= a
// (64 x 16 bf16 from registers, per warp the mma.sync A layout) x B (16 x 64
// from shared memory by descriptor; TRANS_B 1 reads it MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B)
      : "memory");
}


// S = Q K^T for one key tile (K's descriptor kd): m64n64, four k-steps of
// 16 dims, 32 bytes apart, K-major.
__device__ __forceinline__ void wg_scores(float (&s)[kNB][4], const uint32_t (&qf)[4][4],
                                          uint64_t kd) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_n64<0>(s, qf[kc], kd + ((32 * kc) >> 4), kc);
}

// O += P V for one key tile (V's descriptor vd): m64n64, four k-steps of
// 16 keys, 2048 bytes apart, V read MN-major.
__device__ __forceinline__ void wg_pv(float (&o)[8][4], const uint32_t (&pa)[kNB / 2][4],
                                      uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < kNB / 2; ++kk) wgmma_n64<1>(o, pa[kk], vd + ((16 * 128 * kk) >> 4), 1);
}

// One warpgroup of 64 rows per block, four blocks per SM (128 registers a
// thread), key tiles of 64.  Software pipeline, after FA3: the products S
// of tile kt+1 and PV of tile kt are in flight on the tensor cores while the
// softmax of tile kt+1 runs; P is re-packed only once PV of tile kt has
// retired.  A ring of three (K, V) stages: iteration kt loads tile kt+2 into
// the stage tile kt-1 freed.  One block barrier per tile; no wgmma sits on a
// divergent path.
template <bool CAUSAL>
__global__ void __launch_bounds__(kWgThreads, 4)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out, int hq, int hkv, int n, int hb,
                             float sl2_signed) {
  constexpr int D = 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t sbase = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-byte aligned tiles
  const uint64_t desc0 = wg_desc(sbase);
  const float sl2 = fmaxf(fabsf(sl2_signed), 1.17549435e-38f);  // > 0: -inf * sl2 = -inf

  const Block blk(hq, hkv, n, hb, CAUSAL, kWgRows);
  const __nv_bfloat16* kb = k + ((size_t)blk.b * hkv + blk.kvh) * n * D;
  const __nv_bfloat16* vb = v + ((size_t)blk.b * hkv + blk.kvh) * n * D;
  const int f = threadIdx.x / 32;  // this warp's m-tile
  const int r0 = blk.pos(f) + ((threadIdx.x % 32) >> 2);
  const int first = blk.pos(f);
  const int n_kt = blk.n_kt;
  auto masked = [&](int kt) {
    return kt * kTileK + kTileK > n || (CAUSAL && kt * kTileK + kTileK - 1 > first);
  };
  // K of stage i at sbase + i * kWgStageBytes, V right after it
  auto kdesc = [&](int i) { return desc0 + ((i * kWgStageBytes) >> 4); };
  auto vdesc = [&](int i) { return desc0 + ((i * kWgStageBytes + kWgTileBytes) >> 4); };
  auto next = [](int i) { return i == kWgStages - 1 ? 0 : i + 1; };

  uint32_t qf[D / 16][4];
  load_q<D>(qf, q, blk.b, hq, blk.head(f), r0, n, sl2_signed < 0.f);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  Rows2 st{-INFINITY, -INFINITY, 0.f, 0.f};

  const TileLoader<D, kWgThreads> load;
  load(sbase, sbase + kWgTileBytes, kb, vb, 0, n);
  cp_async_commit();
  if (n_kt > 1) load(sbase + kWgStageBytes, sbase + kWgStageBytes + kWgTileBytes, kb, vb, 1, n);
  cp_async_commit();
  cp_async_wait<1>();
  // the tiles are written through the generic proxy; wgmma reads them
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // S and the softmax of tile 0; each iteration then starts by retiring the
  // previous PV, rescaling O and packing P, so that the softmax at the end
  // of an iteration overlaps that PV (a wait placed after it in the same
  // block may be hoisted by the compiler)
  float s[kNB][4];
  uint32_t pa[kNB / 2][4];
  float a0, a1;
  bool resc;
  wg_fence();
  wg_scores(s, qf, kdesc(0));
  wg_commit();
  wg_wait<0>();
  fence_acc(s);
  softmax_tile<CAUSAL>(s, st, a0, a1, resc, masked(0), 0, r0, n, sl2);

  int cur = 0, nxt = 1, ld = 2;  // stages of tiles kt, kt+1, kt+2
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    wg_wait<0>();  // PV of tile kt-1
    fence_acc(acc);
    if (resc) rescale(acc, a0, a1);
    pack_p(pa, s);
    // tile kt+1 has landed, and every thread is done with tile kt-1, whose
    // stage tile kt+2 refills
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + 2 < n_kt)
      load(sbase + ld * kWgStageBytes, sbase + ld * kWgStageBytes + kWgTileBytes, kb, vb, kt + 2,
           n);
    cp_async_commit();
    fence_acc(acc);
    wg_fence();
    wg_scores(s, qf, kdesc(nxt));
    wg_commit();
    wg_pv(acc, pa, vdesc(cur));
    wg_commit();
    wg_wait<1>();  // S of tile kt+1 is done; PV of tile kt runs on
    fence_acc(s);
    softmax_tile<CAUSAL>(s, st, a0, a1, resc, masked(kt + 1), (kt + 1) * kTileK, r0,
                                n, sl2);
    cur = nxt;
    nxt = ld;
    ld = next(ld);
  }
  // PV of the last tile (its stage was waited for one iteration ago, or in
  // the prologue)
  wg_wait<0>();
  fence_acc(acc);
  if (resc) rescale(acc, a0, a1);
  pack_p(pa, s);
  fence_acc(acc);
  wg_fence();
  wg_pv(acc, pa, vdesc(cur));
  wg_commit();
  wg_wait<0>();
  fence_acc(acc);
  store_rows<D>(out + ((size_t)blk.b * hq + blk.head(f)) * n * D, acc, st, r0, n);
}

// ---------------------------------------------------------------------------
// f32: one query head and 64 rows per block, products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32TileQ = 16 * kF32Warps;  // query rows per block

template <int D>
struct F32Layout {
  static constexpr int kStride = D + 4;       // K, V and Q rows: 16 B of padding
  static constexpr int kPStride = kTileK + 4; // each warp's P (16, kTileK + 4)
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)2 * kTileK * kStride + (size_t)kF32TileQ * kStride +
                       (size_t)kF32Warps * 16 * kPStride);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int hq, int hkv,
                           int n, float scale) {
  using L = F32Layout<D>;
  constexpr int kDB = D / 8;  // n-blocks of 8 output dims
  constexpr int kVecPerRow = D / 4;
  extern __shared__ __align__(16) unsigned char smem_f32_raw[];
  float* ks = reinterpret_cast<float*>(smem_f32_raw);
  float* vs = ks + kTileK * L::kStride;
  float* qs = vs + kTileK * L::kStride;

  const int n_qt = (n + kF32TileQ - 1) / kF32TileQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const float* qb = q + ((size_t)b * hq + h) * n * D;
  const float* kb = k + ((size_t)b * hkv + hk) * n * D;
  const float* vb = v + ((size_t)b * hkv + hk) * n * D;
  float* ob = out + ((size_t)b * hq + h) * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kF32TileQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  float* ps = qs + kF32TileQ * L::kStride + warp * 16 * L::kPStride;

  float acc[kDB][4];
#pragma unroll
  for (int j = 0; j < kDB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = threadIdx.x; i < kF32TileQ * D; i += kF32Threads) {
    const int row = i / D, c = i % D;
    qs[row * L::kStride + c] = (q0 + row < n) ? qb[(size_t)(q0 + row) * D + c] : 0.f;
  }

  const int n_kt_all = (n + kTileK - 1) / kTileK;
  const int n_kt = CAUSAL ? min(n_kt_all, (q0 + kF32TileQ - 1) / kTileK + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kF32Threads) {
      const int row = i / kVecPerRow, c = (i % kVecPerRow) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < n) {
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + row) * D + c);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + row) * D + c);
      }
      *reinterpret_cast<float4*>(ks + row * L::kStride + c) = kv4;
      *reinterpret_cast<float4*>(vs + row * L::kStride + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T: s[j] holds rows (g, g+8) x keys 8j + 2t + (0, 1)
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const float* qa = qs + (warp * 16 + g) * L::kStride;
    const float* qc = qa + 8 * L::kStride;
    for (int e = 0; e < D; ++e) {
      const float x0 = qa[e], x1 = qc[e];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float kvv = ks[(8 * j + 2 * t + c) * L::kStride + e];
          s[j][c] = fmaf(x0, kvv, s[j][c]);
          s[j][2 + c] = fmaf(x1, kvv, s[j][2 + c]);
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
          const float vv = vs[key * L::kStride + 8 * j + 2 * t + c];
          acc[j][c] = fmaf(p0, vv, acc[j][c]);
          acc[j][2 + c] = fmaf(p1, vv, acc[j][2 + c]);
        }
      }
    }
    __syncwarp();
  }

  // acc / max(denom, 1e-30)
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDB; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < n)
      *reinterpret_cast<float2*>(ob + (size_t)r0 * D + col) =
          make_float2(acc[j][0] / d0, acc[j][1] / d0);
    if (r1 < n)
      *reinterpret_cast<float2*>(ob + (size_t)r1 * D + col) =
          make_float2(acc[j][2] / d1, acc[j][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool CAUSAL>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
                int n, int hb, float scale, cudaStream_t stream) {
  const int pt = (D == 64 ? kWgRows : kMmaRows) / hb;
  const dim3 grid((unsigned)b * (unsigned)(hq / hb), (n + pt - 1) / pt);
  const float sl2 = scale * kLog2e;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if constexpr (D == 64) {
    auto kern = flash_attention_wgmma_kernel<CAUSAL>;
    int err = set_smem(kern, kWgSmem);
    if (err) return err;
    kern<<<grid, kWgThreads, kWgSmem, stream>>>(qp, kp, vp, op, hq, hkv, n, hb, sl2);
  } else {
    using C = MmaCfg<D>;
    auto kern = flash_attention_mma_kernel<D, CAUSAL>;
    int err = set_smem(kern, C::kSmem);
    if (err) return err;
    kern<<<grid, C::kThreads, C::kSmem, stream>>>(qp, kp, vp, op, hq, hkv, n, hb, sl2);
  }
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
               int n, float scale, cudaStream_t stream) {
  auto kern = flash_attention_f32_kernel<D, CAUSAL>;
  const size_t smem = F32Layout<D>::kBytes;
  int err = set_smem(kern, smem);
  if (err) return err;
  const dim3 grid((n + kF32TileQ - 1) / kF32TileQ, hq, b);
  kern<<<grid, kF32Threads, smem, stream>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v),
                                            static_cast<float*>(out), hq, hkv, n, scale);
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
int launch_d(int dtype_code, int d, const void* q, const void* k, const void* v, void* out,
             int b, int hq, int hkv, int n, int hb, float scale, cudaStream_t s) {
  if (dtype_code == 0) {
    switch (d) {
      case 16: return launch_bf16<16, CAUSAL>(q, k, v, out, b, hq, hkv, n, hb, scale, s);
      case 32: return launch_bf16<32, CAUSAL>(q, k, v, out, b, hq, hkv, n, hb, scale, s);
      case 64: return launch_bf16<64, CAUSAL>(q, k, v, out, b, hq, hkv, n, hb, scale, s);
      case 128: return launch_bf16<128, CAUSAL>(q, k, v, out, b, hq, hkv, n, hb, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 16: return launch_f32<16, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 32: return launch_f32<32, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 64: return launch_f32<64, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    case 128: return launch_f32<128, CAUSAL>(q, k, v, out, b, hq, hkv, n, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

size_t smem_bf16(int d) {
  switch (d) {
    case 16: return MmaCfg<16>::kSmem;
    case 32: return MmaCfg<32>::kSmem;
    case 64: return kWgSmem;
    case 128: return MmaCfg<128>::kSmem;
    default: return 0;
  }
}

size_t smem_f32(int d) {
  switch (d) {
    case 16: return F32Layout<16>::kBytes;
    case 32: return F32Layout<32>::kBytes;
    case 64: return F32Layout<64>::kBytes;
    case 128: return F32Layout<128>::kBytes;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = bf16, 1 = f32.  0 for a head dim the kernel does not take.
size_t flash_attention_smem_bytes(int dtype_code, int d) {
  return dtype_code == 0 ? smem_bf16(d) : smem_f32(d);
}

// q (B, Hq, N, d), k and v (B, Hkv, N, d), out (B, Hq, N, d), all contiguous
// in one type (dtype_code 0 = bf16, 1 = f32), 16-byte aligned; d in {16, 32,
// 64, 128}; Hq a multiple of Hkv; heads_per_block (bf16 only) from
// `flash_attention.block_geometry`.  Returns cudaGetLastError() after the
// launch (0 on success).
int flash_attention_launch(int dtype_code, int causal, const void* q, const void* k,
                           const void* v, void* out, int b, int hq, int hkv, int n, int d,
                           int heads_per_block, float scale, void* stream) {
  if (b == 0 || hq == 0 || n == 0) return 0;
  if (dtype_code != 0 && dtype_code != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? launch_d<true>(dtype_code, d, q, k, v, out, b, hq, hkv, n, heads_per_block,
                                 scale, s)
                : launch_d<false>(dtype_code, d, q, k, v, out, b, hq, hkv, n, heads_per_block,
                                  scale, s);
}

}  // extern "C"
