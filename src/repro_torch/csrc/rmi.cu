// Fused two-level RMI inference -> equi-depth bucket id: the Hopper RMI
// kernel.
//
// Replaces src/repro/kernels/rmi.py:rmi_bucket_pallas (_rmi_kernel,
// _feature): global feature (two-word subtract with borrow, f32, clip,
// below-min -> 0), root line -> leaf, leaf-row gather, leaf-local feature,
// clamped leaf line, x n_buckets -> id.
//
// What bounds it on an H100: not device-memory bytes (16 read and 4
// written a record, plus the leaf table once) and not arithmetic (~20
// float operations a record), but the leaf-row gather.  Each record reads
// the row of the leaf its key routes to; on uniform keys the 32 records
// of a warp hit 32 different rows, so the gather's transactions and their
// latency, served by the L2, set the time.  The design cuts the
// transactions:
//
// * one 32-byte row a leaf (core/rmi.py:pack_leaf_table, LEAF_ROW):
//   slope, intercept, band lo/hi and inv_range as f32 bit patterns, the
//   leaf's min hi/lo words as u32, one pad word.  The table's base is
//   32-byte aligned, so a row is one sector, read by two 16-byte
//   read-only loads (ld.global.nc.v4).  Split (L, 5) f32 and (L, 2)
//   int64 tables took seven scalar loads over ~2.5 sectors a record.
// * one record a thread, its words and id moved by coalesced scalar
//   accesses (the words by streaming, evict-first loads, 3-5 % faster
//   than cached ones), and the grid from n (256 threads a block, no
//   loop).  Two,
//   four and eight records a thread, with 16-byte loads of the words and
//   one 16-byte store of the ids, were measured and lose on uniform keys
//   and gain nothing on skewed ones (experiments/rmi_histogram_variants.py,
//   PERF.md): more gathers in flight a thread do not shorten the gather.
//
// The table is NOT staged in shared memory: the main path trains 25,000
// to 65,536 leaves, 0.8-2.1 MB packed, far above the 227 KB a block can
// hold, but well inside the 50 MB L2.
//
// Exactness: ids must equal the reference bit for bit, so every multiply
// and add is a separately rounded __fmul_rn / __fadd_rn (never contracted
// into an FMA; the build passes -fmad=false too), and float -> int casts
// use __float2int_rz, which truncates and saturates (NaN -> 0) exactly as
// XLA's convert does.  Clamps are written as compares that let NaN
// through, as jnp.clip does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Model {
  uint32_t min_hi, min_lo;
  float inv_range, root_slope, root_intercept, n_buckets_f;
  int n_buckets, n_leaf;
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// repro/kernels/rmi.py:_feature on one record.
__device__ __forceinline__ float feature(uint32_t h, uint32_t l, uint32_t mh,
                                         uint32_t ml, float inv_range) {
  bool below = (h < mh) || (h == mh && l < ml);
  uint32_t borrow = l < ml ? 1u : 0u;
  uint32_t dlo = l - ml;
  uint32_t dhi = h - mh - borrow;
  float x = __fadd_rn(__fmul_rn(__uint2float_rn(dhi), 4294967296.0f),
                      __uint2float_rn(dlo));
  return below ? 0.0f : clip(__fmul_rn(x, inv_range), 0.0f, 1.0f);
}

__device__ __forceinline__ int leaf_of(uint32_t h, uint32_t l,
                                       const Model& m) {
  float x = feature(h, l, m.min_hi, m.min_lo, m.inv_range);
  float r = __fmul_rn(__fadd_rn(__fmul_rn(x, m.root_slope), m.root_intercept),
                      (float)m.n_leaf);
  int leaf = __float2int_rz(r);
  return leaf < 0 ? 0 : (leaf > m.n_leaf - 1 ? m.n_leaf - 1 : leaf);
}

// The id from the leaf row's two halves: a = (slope, intercept, band_lo,
// band_hi), b = (inv_range, min_hi, min_lo, pad).
__device__ __forceinline__ int bucket(uint32_t h, uint32_t l, uint4 a, uint4 b,
                                      const Model& m) {
  float xl = feature(h, l, b.y, b.z, __uint_as_float(b.x));
  float y = clip(__fadd_rn(__fmul_rn(xl, __uint_as_float(a.x)),
                           __uint_as_float(a.y)),
                 __uint_as_float(a.z), __uint_as_float(a.w));
  int id = __float2int_rz(__fmul_rn(y, m.n_buckets_f));
  return id < m.n_buckets - 1 ? id : m.n_buckets - 1;
}

__global__ void __launch_bounds__(kThreads)
    rmi_kernel(const long long* __restrict__ hi,
               const long long* __restrict__ lo, long long n, Model m,
               const uint4* __restrict__ table, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // words are read once: streaming loads leave the caches to the rows
  const uint32_t h = (uint32_t)__ldcs(hi + i), l = (uint32_t)__ldcs(lo + i);
  const uint4* row = table + 2 * leaf_of(h, l, m);
  out[i] = bucket(h, l, __ldg(row), __ldg(row + 1), m);
}

}  // namespace

// hi, lo: (n,) int64; table: (n_leaf, 8) 32-bit leaf rows, 32-byte
// aligned; out: (n,) int32.
extern "C" int repro_rmi_bucket(const void* hi, const void* lo, long long n,
                                unsigned min_hi, unsigned min_lo,
                                float inv_range, float root_slope,
                                float root_intercept, int n_buckets,
                                const void* table, int n_leaf, void* out,
                                void* stream) {
  if ((uintptr_t)table % 32 != 0) return (int)cudaErrorMisalignedAddress;
  if (n > 0) {
    const Model m{min_hi, min_lo, inv_range, root_slope, root_intercept,
                  (float)n_buckets, n_buckets, n_leaf};
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    rmi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)hi, (const long long*)lo, n, m, (const uint4*)table,
        (int*)out);
  }
  return (int)cudaGetLastError();
}
