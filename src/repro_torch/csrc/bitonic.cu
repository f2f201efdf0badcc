// Row-wise bitonic sort of (hi, lo, val) rows: the Hopper touch-up sorter.
//
// Replaces src/repro/kernels/bitonic.py:sort_rows_pallas (_make_kernel,
// _stage_list, _partner_swap), which sorted 8-row VMEM tiles with a static
// network of flip-and-select stages.
//
// Order: strict on (hi, lo, val), as bitonic.py:68-72 -- duplicate keys can
// never duplicate or drop a payload, and SENTINEL keys sort last.
//
// Bound: memory at the main path's widths.  A row of C slots reads and
// writes 20 bytes a slot (int64 hi, int64 lo, int32 val) once; the
// log2C(log2C+1)/2 compare-exchange stages run on shared memory.  Design:
// one block per row.  The row is loaded once into dynamic shared memory as
// one packed u64 key (hi << 32 | lo, the same unsigned order as the word
// pair) plus the int32 val -- 12 bytes a slot, 12 KB at C = 1024 -- and
// each thread owns C / 2 / blockDim compare-exchange pairs per stage, with
// __syncthreads() between stages.  Widths above 16,384 do not fit the
// 227 KB of shared memory a block may use; the wrapper rejects them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool greater(unsigned long long ka, int va,
                                        unsigned long long kb, int vb) {
  return ka > kb || (ka == kb && va > vb);
}

__global__ void bitonic_kernel(const long long* __restrict__ hi,
                               const long long* __restrict__ lo,
                               const int* __restrict__ val,
                               long long* __restrict__ hi_out,
                               long long* __restrict__ lo_out,
                               int* __restrict__ val_out, int c) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;
  int* v = (int*)(smem + c);
  const long long base = (long long)blockIdx.x * c;

  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    key[i] = ((unsigned long long)(uint32_t)hi[base + i] << 32) |
             (unsigned long long)(uint32_t)lo[base + i];
    v[i] = val[base + i];
  }
  __syncthreads();

  const int half = c >> 1;
  for (int k = 2; k <= c; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // t-th pair of this stage: the lower index has bit j clear
        int a = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        int b = a | j;
        bool ascending = (a & k) == 0;
        unsigned long long ka = key[a], kb = key[b];
        int va = v[a], vb = v[b];
        if (greater(ka, va, kb, vb) == ascending) {
          key[a] = kb;
          key[b] = ka;
          v[a] = vb;
          v[b] = va;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    unsigned long long kv = key[i];
    hi_out[base + i] = (long long)(kv >> 32);
    lo_out[base + i] = (long long)(kv & 0xFFFFFFFFull);
    val_out[base + i] = v[i];
  }
}

}  // namespace

// Shared memory bytes for one row of width c.
extern "C" long long repro_bitonic_smem_bytes(int c) {
  return (long long)c * (sizeof(unsigned long long) + sizeof(int));
}

// hi, lo: (r, c) int64; val: (r, c) int32; c a power of two; outputs alike.
extern "C" int repro_sort_rows(const void* hi, const void* lo, const void* val,
                               void* hi_out, void* lo_out, void* val_out,
                               long long r, int c, void* stream) {
  if (r > 0 && c > 0) {
    size_t smem = (size_t)repro_bitonic_smem_bytes(c);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          bitonic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int threads = c / 2 < 1 ? 1 : (c / 2 > 1024 ? 1024 : c / 2);
    bitonic_kernel<<<(unsigned)r, threads, smem, (cudaStream_t)stream>>>(
        (const long long*)hi, (const long long*)lo, (const int*)val,
        (long long*)hi_out, (long long*)lo_out, (int*)val_out, c);
  }
  return (int)cudaGetLastError();
}
