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
// What bounds it on an H100: 4 bytes read per id and 4 written per bin
// are a few microseconds; the atomics are what cost.  A private
// histogram per block, flushed to the output by one global atomic per
// nonzero bin, spends about as many flush atomics as ids at 8,192 bins;
// equal ids serialise on one address.  Three strategies, chosen by
// kernels/histogram.py:launch_geometry from the bins a block's shared
// memory holds (58,112 on an H100):
//
// * shared (the bins fit one block): thread-block clusters of `cluster`
//   blocks.  Each block counts its ids into a private histogram in its
//   own shared memory (local atomics, the fastest add there is).  Then
//   the cluster reduces through distributed shared memory: block r reads
//   slice r of every block's histogram (map_shared_rank), sums it and
//   flushes each nonzero sum with one global atomic -- one flush a
//   cluster, not one a block.
// * split (the bins fit two blocks: up to 116,224 on an H100): clusters
//   of 2 split the bins, block r owning [r * slice, (r + 1) * slice) in
//   its shared memory; a block adds an id into its owner's slice through
//   distributed shared memory (map_shared_rank, then atomicAdd), and each
//   block flushes its own slice.  Clusters of 4 to 16, which would hold
//   up to 16 x 58,112 bins, lose to global atomics (an add into another
//   block's shared memory costs more than an L2 atomic; PERF.md), so the
//   launch takes any size up to 16 but the geometry picks 2.
// * global (2**20 bins: 4 MB fits no cluster): one global atomic an id,
//   resolved in the L2.
//
// In both cluster strategies cluster.sync() separates the phases: after
// the zeroing (no add before every histogram is zero), before the
// reduction or flush (every add is done), and, in the shared strategy,
// after the reduction (no block exits while another still reads its
// memory).  Equal ids: a warp step whose ids (256 in the cluster
// strategies, 128 in the global one) are all one in-range id (all-equal
// ids, or a run of them) makes one add of them all; other steps add an
// id at a time.  Grouping a warp's equal ids by __match_any_sync and
// adding __popc of each group was measured too: it doubles the time on
// ids that seldom repeat in a warp (PERF.md).
//
// The grid is set by the SM count: in the cluster strategies two blocks
// an SM at most, capped by the clusters the device holds at once
// (cudaOccupancyMaxActiveClusters); in the global strategy eight; fewer
// where n gives them too little work.  The output is zeroed on the
// stream first (cudaMemsetAsync).  Nothing here waits on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;         // cluster strategies
constexpr int kGlobalBlocksPerSm = 8;   // global strategy: 2,048 threads

enum Strategy { kGlobal = 0, kShared = 1, kSplit = 2 };

// ids a lane takes a step, and so a warp step's 32 x that: 4 in the
// global strategy, whose L2 atomics start sooner after shorter steps (8
// costs ~2 % there; 1 or 2 leave an all-equal step too few ids to merge)
template <int S>
constexpr int kPerLane = S == kGlobal ? 4 : 8;
template <int S>
constexpr int kWarpStep = 32 * kPerLane<S>;
template <int S>
constexpr int kBlockStep = kThreads / 32 * kWarpStep<S>;

// count more of in-range bin id
template <int S>
__device__ __forceinline__ void add(int* bins, int slice, int* out, int id,
                                    int count) {
  if (S == kShared) {
    atomicAdd(bins + id, count);
  } else if (S == kSplit) {
    const unsigned owner = (unsigned)id / (unsigned)slice;
    int* dst = cg::this_cluster().map_shared_rank(bins, owner);
    atomicAdd(dst + (id - (int)owner * slice), count);
  } else {
    atomicAdd(out + id, count);
  }
}

// block_bins: bins a block's shared memory holds; slice: bins block r of
// a cluster owns, from r * slice.
template <int S>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ ids, long long n, int n_buckets,
                int block_bins, int slice, int* __restrict__ out) {
  extern __shared__ int bins[];
  const unsigned lane = threadIdx.x & 31;
  if (S != kGlobal) {
    for (int b = threadIdx.x; b < block_bins; b += kThreads) bins[b] = 0;
    cg::this_cluster().sync();
  }
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const long long stride = (long long)gridDim.x * kBlockStep<S>;
  // the loop bound is the warp's, so every lane takes every step
  for (long long base = warp * kWarpStep<S>; base < n; base += stride) {
    int v[kPerLane<S>];
    bool same = true;
#pragma unroll
    for (int r = 0; r < kPerLane<S>; ++r) {
      const long long i = base + r * 32 + lane;
      const int id = i < n ? __ldg(ids + i) : -1;
      v[r] = (unsigned)id < (unsigned)n_buckets ? id : -1;
      same = same && v[r] == v[0];
    }
    const int first = __shfl_sync(0xffffffffu, v[0], 0);
    if (__all_sync(0xffffffffu, same && v[0] == first) && first >= 0) {
      if (lane == 0) add<S>(bins, slice, out, first, kWarpStep<S>);
      continue;
    }
#pragma unroll
    for (int r = 0; r < kPerLane<S>; ++r)
      if (v[r] >= 0) add<S>(bins, slice, out, v[r], 1);
  }
  if (S == kGlobal) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = lo + slice < n_buckets ? lo + slice : n_buckets;
  if (S == kSplit) {
    for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
      const int c = bins[b - lo];
      if (c) atomicAdd(out + b, c);
    }
    return;
  }
  const unsigned blocks = cluster.num_blocks();
  for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
    int c = 0;
    for (unsigned q = 0; q < blocks; ++q)
      c += cluster.map_shared_rank(bins, q)[b];
    if (c) atomicAdd(out + b, c);
  }
  cluster.sync();
}

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// A cluster launch of `kernel`: its attributes set, a grid of one
// cluster for the occupancy query (the caller sets gridDim).
cudaError_t cluster_config(const void* kernel, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int cluster,
                           int block_bins, cudaStream_t s) {
  const size_t smem = (size_t)block_bins * sizeof(int);
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  if (cluster > 8 &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1)) != cudaSuccess)
    return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int S>
cudaError_t launch_cluster(const int* ids, long long n, int n_buckets,
                           int cluster, int block_bins, int slice, int* out,
                           int n_sm, cudaStream_t s) {
  const void* kernel = (const void*)hist_kernel<S>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kernel, &cfg, &attr, cluster, block_bins, s);
  if (e != cudaSuccess) return e;
  int active = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg)) !=
      cudaSuccess)
    return e;
  long long clusters =
      ((n + kBlockStep<S> - 1) / kBlockStep<S> + cluster - 1) / cluster;
  long long cap = (long long)kBlocksPerSm * n_sm / cluster;
  if (cap > active) cap = active;
  if (clusters > cap) clusters = cap;
  if (clusters < 1) clusters = 1;
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  return cudaLaunchKernelEx(&cfg, hist_kernel<S>, ids, n, n_buckets,
                            block_bins, slice, out);
}

}  // namespace

// The most bins a block's shared memory holds.
extern "C" int repro_histogram_max_bins(int* max_bins) {
  int smem = 0;
  cudaError_t e = smem_optin(&smem);
  *max_bins = smem / (int)sizeof(int);
  return (int)e;
}

// ids: (n,) int32; out: (n_buckets,) int32, overwritten.  strategy: 0
// global, 1 shared, 2 split; cluster, block_bins and slice as
// kernels/histogram.py:launch_geometry gives them (ignored for global).
extern "C" int repro_histogram(const void* ids, long long n, int n_buckets,
                               int strategy, int cluster, int block_bins,
                               int slice, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int smem = 0;
  cudaError_t e = smem_optin(&smem);
  if (e != cudaSuccess) return (int)e;
  const bool clustered = strategy == kShared || strategy == kSplit;
  if ((strategy != kGlobal && !clustered) ||
      (clustered &&
       (cluster < 1 || cluster > 16 || slice < 1 ||
        (long long)cluster * slice < n_buckets ||
        (long long)block_bins * (long long)sizeof(int) > smem ||
        block_bins < (strategy == kShared ? n_buckets : slice))))
    return (int)cudaErrorInvalidValue;
  if ((e = cudaMemsetAsync(out, 0, (size_t)n_buckets * sizeof(int), s)) !=
          cudaSuccess ||
      n == 0)
    return (int)e;
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int* in = (const int*)ids;
  int* o = (int*)out;
  if (strategy == kShared) {
    e = launch_cluster<kShared>(in, n, n_buckets, cluster, block_bins, slice,
                                o, n_sm, s);
  } else if (strategy == kSplit) {
    e = launch_cluster<kSplit>(in, n, n_buckets, cluster, block_bins, slice,
                               o, n_sm, s);
  } else {
    const long long blocks =
        (n + kBlockStep<kGlobal> - 1) / kBlockStep<kGlobal>;
    const long long cap = (long long)kGlobalBlocksPerSm * n_sm;
    hist_kernel<kGlobal><<<(unsigned)(blocks < cap ? blocks : cap), kThreads,
                           0, s>>>(in, n, n_buckets, 0, 0, o);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
