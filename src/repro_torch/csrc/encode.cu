// Key bytes -> (hi, lo) words: the Hopper encode kernel.
//
// Replaces src/repro/kernels/encode.py:encode_pallas (_encode_kernel), which
// packed (block_rows, 8) u8 VMEM tiles into two big-endian u32 words.
//
// Bound: memory.  Each record reads 8 bytes and writes two int64 words
// (16 bytes); there is no arithmetic to speak of.  Design: one thread per
// record issues one 8-byte load of its key prefix (neighbouring threads on
// neighbouring addresses, so a warp reads 256 contiguous bytes), swaps
// each 4-byte half to big-endian with __byte_perm and stores both words
// zero-extended to int64, the port's carrier for unsigned 32-bit words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void encode_kernel(const uint2* __restrict__ keys,
                              long long* __restrict__ hi,
                              long long* __restrict__ lo, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint2 w = keys[i];
  // selector 0x0123 reverses the bytes: b0 b1 b2 b3 -> b0<<24|b1<<16|b2<<8|b3
  hi[i] = (long long)__byte_perm(w.x, 0, 0x0123);
  lo[i] = (long long)__byte_perm(w.y, 0, 0x0123);
}

}  // namespace

// Message for a code returned by any entry point of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// keys: (n, 8) uint8, 8-byte aligned; hi, lo: (n,) int64.
extern "C" int repro_encode(const void* keys, void* hi, void* lo, long long n,
                            void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint2*)keys, (long long*)hi, (long long*)lo, n);
  }
  return (int)cudaGetLastError();
}
