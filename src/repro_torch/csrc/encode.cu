// Key bytes -> (hi, lo) words: the Hopper encode kernel; and key bytes ->
// (hi, lo, tail) words, the full-key encode kernel (below).
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

// Full-key encode: (n, k) key rows, k <= 12, at a row stride of at most
// kMaxStride bytes -> hi (bytes 0-3), lo (4-7) and tail (8-11), each
// big-endian, zero-padded past the key's end and zero-extended to int64.
//
// Replaces no TPU kernel: the JAX package orders bytes 9-12 on the host
// (executor._memcmp_touchup); this kernel feeds the device's full-key sort.
//
// Bound: memory.  Each record reads its k key bytes and writes three words.
// Rows of 10 bytes are neither 4- nor 8-byte aligned, so one thread a row
// would issue k byte loads, each warp load touching ~10 sectors.  Design:
// the block's rows are one span of bytes; its threads copy the span into
// shared memory as aligned 4-byte words (a warp reads 128 contiguous bytes
// a load), then each thread assembles its own row's words from shared
// memory and stores them (neighbouring threads on neighbouring addresses).
// The span starts on the 4-byte boundary at or below the block's first
// byte and ends on the one at or above its last: an aligned word holding
// one byte of the buffer lies inside the buffer's allocation.
// The port's callers (the full-key benchmark's pool, the tests' key
// matrices) pass rows at stride k; a stride up to kMaxStride reads a key
// window sliced from wider rows in place, and the wrapper copies rows
// further apart than that.
constexpr int kFullThreads = 256;
constexpr int kMaxStride = 16;

__global__ void __launch_bounds__(kFullThreads)
    encode_full_kernel(const unsigned char* __restrict__ keys, long long stride,
                       int k, long long* __restrict__ hi,
                       long long* __restrict__ lo,
                       long long* __restrict__ tail, long long n) {
  __shared__ uint32_t span[(kFullThreads * kMaxStride) / 4 + 2];
  const long long r0 = (long long)blockIdx.x * kFullThreads;
  const int rows = (int)min((long long)kFullThreads, n - r0);
  const uintptr_t first = (uintptr_t)(keys + r0 * stride);
  const int lead = (int)(first & 3);
  if (k > 0) {
    const uint32_t* src = (const uint32_t*)(first - lead);
    const int words = (lead + (rows - 1) * (int)stride + k + 3) >> 2;
    for (int j = threadIdx.x; j < words; j += kFullThreads) span[j] = __ldg(src + j);
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const unsigned char* row =
      (const unsigned char*)span + lead + threadIdx.x * (int)stride;
  uint32_t w[3] = {0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 12; ++b) {
    const uint32_t v = b < k ? (uint32_t)row[b] : 0u;
    w[b >> 2] = (w[b >> 2] << 8) | v;
  }
  const long long i = r0 + threadIdx.x;
  hi[i] = (long long)w[0];
  lo[i] = (long long)w[1];
  tail[i] = (long long)w[2];
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

// keys: (n, k) uint8 rows, k <= 12, `stride` bytes apart (k <= stride <= 16);
// hi, lo, tail: (n,) int64.
extern "C" int repro_encode_full(const void* keys, long long stride, int k,
                                 void* hi, void* lo, void* tail, long long n,
                                 void* stream) {
  if (k < 0 || k > 12 || stride < k || stride > kMaxStride) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = (n + kFullThreads - 1) / kFullThreads;
    encode_full_kernel<<<(unsigned)blocks, kFullThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)keys, stride, k, (long long*)hi, (long long*)lo,
        (long long*)tail, n);
  }
  return (int)cudaGetLastError();
}
