// Split-half nibble widen (K8), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/packing.py::unpack_u4_kernel`: a
// (n, dp) uint8 page of q4 codes becomes (n, 2*dp) int32 codes, byte j of a
// row giving code j (its low nibble) and code j + dp (its high nibble).  On
// the contiguous layout the packed exact store widens its q4 codes (and q5's
// low nibbles) through this kernel before the dequant and K2.
//
// What bounds it on the H100: bytes.  Each input byte is read once and two
// int32 codes are written (9 bytes moved per byte, 2 integer operations);
// nothing is reused.  The design is one thread per input byte, so a warp
// reads 32 neighbouring bytes and writes two runs of 32 neighbouring int32s
// (one per half of the output row): every access is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack_u4_kernel(const uint8_t* __restrict__ p, int32_t* __restrict__ out,
                 long long total, int dp) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / dp;
    const long long j = i - row * dp;
    const int b = p[i];
    int32_t* o = out + row * 2 * dp;
    o[j] = b & 0xF;
    o[j + dp] = b >> 4;
  }
}

}  // namespace

extern "C" {

// p (n, dp) uint8 -> out (n, 2*dp) int32, both contiguous.  Returns
// cudaGetLastError() after the launch (0 on success).
int unpack_u4_launch(const void* p, void* out, long long n, int dp, void* stream) {
  const long long total = n * dp;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  unpack_u4_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p), static_cast<int32_t*>(out), total, dp);
  return (int)cudaGetLastError();
}

}  // extern "C"
