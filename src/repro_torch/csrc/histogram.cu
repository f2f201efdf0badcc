// Per-bucket counts of (n,) int32 ids: the Hopper histogram kernel.
//
// Replaces src/repro/kernels/histogram.py:histogram_pallas (_hist_kernel),
// which counted a (block_rows,) tile per grid step as a one-hot compare
// against an iota and accumulated the sum into one output block carried
// across the sequential grid.  Blocks here run in parallel and in no
// order, so the cross-step sum becomes atomics.
//
// Semantics are those of the reference's wrapper and kernel together
// (repro/kernels/ops.py:bucket_histogram): an id outside [0, n_buckets)
// never counts -- the wrapper pads with -1 and the one-hot compare never
// matches it.  The range check is one unsigned compare.
//
// Bound: memory.  4 bytes read per id and 4 written per bin; one add per
// id.  Two strategies, picked by whether the bins fit the shared memory
// a block can opt into (227 KB, 58,112 bins on an H100):
//
// * shared: each block zeroes a private histogram in dynamic shared
//   memory, walks a grid-stride share of the ids with shared-memory
//   atomicAdds, and flushes each nonzero bin with one global atomicAdd.
//   The grid is capped so that every block sees at least n_buckets ids,
//   which keeps the flush (at most n_buckets atomics a block) below the
//   count of ids.
// * global: one global atomicAdd per in-range id, resolved in the L2.
//
// The output is zeroed on the stream first (cudaMemsetAsync).  Nothing
// here waits on the card.  All-equal ids serialise on one bin; they are
// correct, and warp aggregation is a later speed-up.

#include <cuda_runtime.h>

namespace {

const int kThreads = 256;

__global__ void hist_shared(const int* __restrict__ ids, long long n,
                            int n_buckets, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int id = __ldg(ids + i);
    if ((unsigned)id < (unsigned)n_buckets) atomicAdd(&bins[id], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
    int c = bins[b];
    if (c) atomicAdd(out + b, c);
  }
}

__global__ void hist_global(const int* __restrict__ ids, long long n,
                            int n_buckets, int* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int id = __ldg(ids + i);
    if ((unsigned)id < (unsigned)n_buckets) atomicAdd(out + id, 1);
  }
}

}  // namespace

// Largest bin count the shared strategy takes on the current device.
extern "C" int repro_histogram_shared_bins(int* bins) {
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  *bins = smem / (int)sizeof(int);
  return (int)e;
}

// ids: (n,) int32; out: (n_buckets,) int32, overwritten.
extern "C" int repro_histogram(const void* ids, long long n, int n_buckets,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)n_buckets * sizeof(int), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  int dev = 0, n_sm = 0, max_bins = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = (cudaError_t)repro_histogram_shared_bins(&max_bins)) !=
      cudaSuccess)
    return (int)e;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (n_buckets <= max_bins) {
    size_t smem = (size_t)n_buckets * sizeof(int);
    // every block sees >= n_buckets ids; two blocks an SM at most
    long long cap = n / n_buckets;
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    if (blocks > 2LL * n_sm) blocks = 2LL * n_sm;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(hist_shared,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    hist_shared<<<(unsigned)blocks, kThreads, smem, s>>>(
        (const int*)ids, n, n_buckets, (int*)out);
  } else {
    if (blocks > 16LL * n_sm) blocks = 16LL * n_sm;
    hist_global<<<(unsigned)blocks, kThreads, 0, s>>>((const int*)ids, n,
                                                      n_buckets, (int*)out);
  }
  return (int)cudaGetLastError();
}
