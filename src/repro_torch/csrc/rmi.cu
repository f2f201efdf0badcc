// Fused two-level RMI inference -> equi-depth bucket id: the Hopper RMI
// kernel.
//
// Replaces src/repro/kernels/rmi.py:rmi_bucket_pallas (_rmi_kernel,
// _feature): global feature (two-word subtract with borrow, f32, clip,
// below-min -> 0), root line -> leaf, leaf-row gather, leaf-local feature,
// clamped leaf line, x n_buckets -> id.
//
// Bound: memory.  A record reads two int64 words and writes one int32 id;
// the ~20 float operations per record are far below the card's rate.  The
// leaf tables are gathered by leaf id.  They are NOT staged in shared
// memory: the main path trains up to 65,536 leaves (1.8 MB of tables),
// far above the 227 KB a block can hold, but well inside the 50 MB L2, so
// rows are read from global memory through the read-only path (__ldg).
//
// Exactness: ids must equal the reference bit for bit, so every multiply
// and add is a separately rounded __fmul_rn / __fadd_rn (never contracted
// into an FMA), and float -> int casts use __float2int_rz, which truncates
// and saturates (NaN -> 0) exactly as XLA's convert does.  Clamps are
// written as compares that let NaN through, as jnp.clip does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void rmi_kernel(const long long* __restrict__ hi,
                           const long long* __restrict__ lo, long long n,
                           uint32_t min_hi, uint32_t min_lo, float inv_range,
                           float root_slope, float root_intercept,
                           float n_buckets_f, int n_buckets,
                           const float* __restrict__ ftable,
                           const long long* __restrict__ utable, int n_leaf,
                           int* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = (uint32_t)hi[i];
  uint32_t l = (uint32_t)lo[i];

  float x = feature(h, l, min_hi, min_lo, inv_range);
  float r = __fmul_rn(__fadd_rn(__fmul_rn(x, root_slope), root_intercept),
                      (float)n_leaf);
  int leaf = __float2int_rz(r);
  leaf = leaf < 0 ? 0 : (leaf > n_leaf - 1 ? n_leaf - 1 : leaf);

  // (L, 5) f32: slope, intercept, band_lo, band_hi, inv_range
  const float* f = ftable + 5 * (long long)leaf;
  float slope = __ldg(f), icept = __ldg(f + 1);
  float band_lo = __ldg(f + 2), band_hi = __ldg(f + 3);
  float leaf_inv = __ldg(f + 4);
  // (L, 2) int64-carried u32: leaf_min_hi, leaf_min_lo
  const long long* u = utable + 2 * (long long)leaf;
  uint32_t leaf_hi = (uint32_t)__ldg(u), leaf_lo = (uint32_t)__ldg(u + 1);

  float xl = feature(h, l, leaf_hi, leaf_lo, leaf_inv);
  float y = clip(__fadd_rn(__fmul_rn(xl, slope), icept), band_lo, band_hi);
  int b = __float2int_rz(__fmul_rn(y, n_buckets_f));
  out[i] = b < n_buckets - 1 ? b : n_buckets - 1;
}

}  // namespace

// hi, lo: (n,) int64; ftable: (n_leaf, 5) f32; utable: (n_leaf, 2) int64;
// out: (n,) int32.
extern "C" int repro_rmi_bucket(const void* hi, const void* lo, long long n,
                                unsigned min_hi, unsigned min_lo,
                                float inv_range, float root_slope,
                                float root_intercept, int n_buckets,
                                const void* ftable, const void* utable,
                                int n_leaf, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    rmi_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)hi, (const long long*)lo, n, min_hi, min_lo,
        inv_range, root_slope, root_intercept, (float)n_buckets, n_buckets,
        (const float*)ftable, (const long long*)utable, n_leaf, (int*)out);
  }
  return (int)cudaGetLastError();
}
