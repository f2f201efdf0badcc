// Row-wise bitonic sort of (hi, lo, val) rows: the Hopper touch-up sorter.
//
// Replaces src/repro/kernels/bitonic.py:sort_rows_pallas (_make_kernel,
// _stage_list, _partner_swap), which sorted 8-row VMEM tiles with a static
// network of flip-and-select stages.
//
// Order: strict on (hi, lo, val), as bitonic.py:68-72 -- duplicate keys can
// never duplicate or drop a payload, and SENTINEL keys sort last.  The
// network is the standard one (stage (k, j): slot i meets slot i ^ j, and
// the pair ascends where i & k is clear), so every layout below computes
// the same unique answer.
//
// Bound: device memory.  Each slot reads 20 bytes (int64 hi, int64 lo,
// int32 val) and writes 20: 40 B a slot, 335.5 MB at (8192, 1024), 0.1002 ms
// at 3.35 TB/s.  The 55 compare-exchange stages of a 1024-wide row are
// cheap if they stay out of shared memory, which is what the layout does.
//
// Layout: a row of C slots is held by T = C / E threads, E = min(C, 32)
// slots a thread in registers (blocked: thread t holds slots t*E .. t*E +
// E - 1, each as u32 hi, u32 lo and u32 val ^ kSign -- three registers).
// For stage (k, j):
//   j <  E          partner in the same thread: compare-exchange in
//                   registers, no barrier;
//   E <= j < 32 E   partner in lane ^ (j / E) of the same warp: three
//                   __shfl_xor_sync a slot, no barrier;
//   j >= 32 E       partner in another warp (rows wider than 32 E only):
//                   one round trip through shared memory between barriers.
// Rows of C <= 32 E are sorted by one warp or by part of one (32 / T rows
// a warp, four warps a block) with __syncwarp only; wider rows take one
// block each.  Device memory is read and written once, coalesced, as
// 16-byte vectors (longlong2 for hi/lo, int4 for val) into and out of
// shared memory in row order; one shared pass turns that into the blocked
// register layout and one turns it back.  Shared memory holds three u32
// planes with a spare word after every 32 (pad()), so a warp's blocked
// accesses (lane t at slot t*E + e) and its vector accesses fall on 32
// distinct banks.
//
// At C = 1024 (E = 32, one warp a row): 40 stages in registers, 15 by
// shuffles, 0 through shared memory, plus the two layout passes -- 2
// shared-memory round trips a row, against 55 in the design this one
// replaces.  The launch geometry (rows per block, threads per row, E,
// shared bytes) is computed by kernels/bitonic.py:launch_geometry and
// checked again here.
//
// At (8192, 1024) the kernel is held back by the integer ALU more than by
// memory: the loads and stores alone take ~0.12 ms, the network alone ~0.16 ms
// (experiments/bitonic_variants.py, H100 80GB HBM3 at 700 W), so every
// exchange is kept to a 4-instruction 96-bit compare (greater()) and six
// predicated selects.
//
// ptxas -v (-O3, sm_90a), registers a thread, no spills and no stack frame
// in any instantiation: E = 32 warp rows 133; E = 16 / 8 / 4 / 2 / 1
// (C < 32) 79 / 54 / 45 / 37 / 45; block rows 160 (C <= 4096) and 128
// (C = 8192, 16384, under __launch_bounds__(512)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpBlock = 128;  // threads of a block of warp-sorted rows

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

// word of slot i in a padded shared plane
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// (ha, la, va) > (hb, lb, vb) as one 96-bit unsigned number: the borrow
// out of (hb, lb, vb) - (ha, la, va), three chained subtractions
__device__ __forceinline__ bool greater(unsigned ha, unsigned la, unsigned va,
                                        unsigned hb, unsigned lb,
                                        unsigned vb) {
  unsigned borrow;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %6, %3;\n\t"
      "subc.cc.u32 t, %5, %2;\n\t"
      "subc.cc.u32 t, %4, %1;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "r"(ha), "r"(la), "r"(va), "r"(hb), "r"(lb), "r"(vb));
  return borrow != 0;
}

// slots a < b of this thread: the smaller goes to a when asc
template <int E>
__device__ __forceinline__ void exchange(unsigned (&h)[E], unsigned (&l)[E],
                                         unsigned (&v)[E], int a, int b,
                                         bool asc) {
  const bool sw = greater(h[a], l[a], v[a], h[b], l[b], v[b]) == asc;
  const unsigned ha = h[a], la = l[a], va = v[a];
  h[a] = sw ? h[b] : ha;
  l[a] = sw ? l[b] : la;
  v[a] = sw ? v[b] : va;
  h[b] = sw ? ha : h[b];
  l[b] = sw ? la : l[b];
  v[b] = sw ? va : v[b];
}

// keep the partner's slot where it should replace this one
__device__ __forceinline__ void keep(unsigned& h, unsigned& l, unsigned& v,
                                     unsigned ph, unsigned pl, unsigned pv,
                                     bool keep_min) {
  // equal slots are the same slot: keeping either is right
  const bool take = greater(h, l, v, ph, pl, pv) == keep_min;
  h = take ? ph : h;
  l = take ? pl : l;
  v = take ? pv : v;
}

// levels k = 2 .. E: every stage in registers; slot t*E + e ascends in
// level k where (t*E + e) & k is clear
template <int E>
__device__ __forceinline__ void sort_registers(unsigned (&h)[E],
                                               unsigned (&l)[E], unsigned (&v)[E],
                                               int first) {
#pragma unroll
  for (int lk = 1; lk <= ilog2(E); ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & j) == 0) exchange(h, l, v, e, e | j, ((first & k) | (e & k)) == 0);
      }
    }
  }
}

// the last log2 E stages of a level k > E: one direction for the thread
template <int E>
__device__ __forceinline__ void merge_registers(unsigned (&h)[E],
                                                unsigned (&l)[E],
                                                unsigned (&v)[E], bool asc) {
#pragma unroll
  for (int lj = ilog2(E) - 1; lj >= 0; --lj) {
    const int j = 1 << lj;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & j) == 0) exchange(h, l, v, e, e | j, asc);
    }
  }
}

template <int E>
__device__ __forceinline__ void merge_shuffle(unsigned (&h)[E],
                                              unsigned (&l)[E], unsigned (&v)[E],
                                              int m, bool keep_min) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned ph = __shfl_xor_sync(kFull, h[e], m);
    const unsigned pl = __shfl_xor_sync(kFull, l[e], m);
    const unsigned pv = __shfl_xor_sync(kFull, v[e], m);
    keep(h[e], l[e], v[e], ph, pl, pv, keep_min);
  }
}

// val is carried as val ^ kSign: an unsigned word in the same order, so a
// whole slot compares as one 96-bit unsigned number
constexpr unsigned kSign = 0x80000000u;

// device rows [base, base + n) -> the three shared planes, in row order
__device__ __forceinline__ void load_rows(
    const long long* __restrict__ hi, const long long* __restrict__ lo,
    const int* __restrict__ val, long long base, int n, unsigned* sh,
    unsigned* sl, unsigned* sv, int i0, int step, bool vec) {
  int s2 = 0, s4 = 0;
  if (vec) {
    s2 = n & ~1;
    for (int s = 2 * i0; s < s2; s += 2 * step) {
      const longlong2 h2 = __ldg((const longlong2*)(hi + base + s));
      const longlong2 l2 = __ldg((const longlong2*)(lo + base + s));
      const int p = pad(s);
      sh[p] = (unsigned)h2.x;
      sh[p + 1] = (unsigned)h2.y;
      sl[p] = (unsigned)l2.x;
      sl[p + 1] = (unsigned)l2.y;
    }
    s4 = n & ~3;
    for (int s = 4 * i0; s < s4; s += 4 * step) {
      const int4 v4 = __ldg((const int4*)(val + base + s));
      const int p = pad(s);
      sv[p] = (unsigned)v4.x ^ kSign;
      sv[p + 1] = (unsigned)v4.y ^ kSign;
      sv[p + 2] = (unsigned)v4.z ^ kSign;
      sv[p + 3] = (unsigned)v4.w ^ kSign;
    }
  }
  for (int s = s2 + i0; s < n; s += step) {
    sh[pad(s)] = (unsigned)hi[base + s];
    sl[pad(s)] = (unsigned)lo[base + s];
  }
  for (int s = s4 + i0; s < n; s += step) {
    sv[pad(s)] = (unsigned)val[base + s] ^ kSign;
  }
}

// the three shared planes -> device rows [base, base + n), words
// zero-extended to int64
__device__ __forceinline__ void store_rows(
    long long* __restrict__ hi, long long* __restrict__ lo,
    int* __restrict__ val, long long base, int n, const unsigned* sh,
    const unsigned* sl, const unsigned* sv, int i0, int step, bool vec) {
  int s2 = 0, s4 = 0;
  if (vec) {
    s2 = n & ~1;
    for (int s = 2 * i0; s < s2; s += 2 * step) {
      const int p = pad(s);
      *(longlong2*)(hi + base + s) =
          make_longlong2((long long)sh[p], (long long)sh[p + 1]);
      *(longlong2*)(lo + base + s) =
          make_longlong2((long long)sl[p], (long long)sl[p + 1]);
    }
    s4 = n & ~3;
    for (int s = 4 * i0; s < s4; s += 4 * step) {
      const int p = pad(s);
      *(int4*)(val + base + s) =
          make_int4((int)(sv[p] ^ kSign), (int)(sv[p + 1] ^ kSign),
                    (int)(sv[p + 2] ^ kSign), (int)(sv[p + 3] ^ kSign));
    }
  }
  for (int s = s2 + i0; s < n; s += step) {
    hi[base + s] = (long long)sh[pad(s)];
    lo[base + s] = (long long)sl[pad(s)];
  }
  for (int s = s4 + i0; s < n; s += step) {
    val[base + s] = (int)(sv[pad(s)] ^ kSign);
  }
}

// ROW_BLOCK: one block a row of c = blockDim.x * E slots.  Otherwise each
// warp sorts 32 * E consecutive slots: 32 / T rows of c = T * E slots.
template <int E, bool ROW_BLOCK, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    bitonic_kernel(const long long* __restrict__ hi,
                   const long long* __restrict__ lo,
                   const int* __restrict__ val, long long* __restrict__ hi_out,
                   long long* __restrict__ lo_out, int* __restrict__ val_out,
                   long long r, int c, bool vec) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  long long base;
  int n, q, t, i0, step;
  unsigned* sh = smem;
  if (ROW_BLOCK) {
    base = (long long)blockIdx.x * c;
    n = c;
    q = t = threadIdx.x;
    i0 = threadIdx.x;
    step = blockDim.x;
  } else {
    const int warp = threadIdx.x >> 5;
    base = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * (32 * E);
    if (base >= r * c) return;  // whole rows only: no partner is left behind
    n = (int)min((long long)(32 * E), r * c - base);
    q = lane;
    t = lane & (c / E - 1);
    i0 = lane;
    step = 32;
    sh += warp * 3 * (33 * E);
  }
  const int plane = ROW_BLOCK ? c + (c >> 5) : 33 * E;
  unsigned* sl = sh + plane;
  unsigned* sv = sl + plane;

  load_rows(hi, lo, val, base, n, sh, sl, sv, i0, step, vec);
  if (ROW_BLOCK) __syncthreads(); else __syncwarp();

  unsigned h[E], l[E], v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = pad(q * E + e);
    h[e] = sh[p];
    l[e] = sl[p];
    v[e] = sv[p];
  }

  const int first = t * E;
  sort_registers<E>(h, l, v, first);
  for (int k = 2 * E; k <= c; k <<= 1) {
    const bool asc = (first & k) == 0;
    if (ROW_BLOCK) {
      for (int j = k >> 1; j >= 32 * E; j >>= 1) {
        // partner in another warp: one round trip through shared memory
        const bool keep_min = ((first & j) == 0) == asc;
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = pad(first + e);
          sh[p] = h[e];
          sl[p] = l[e];
          sv[p] = v[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = pad((first + e) ^ j);
          keep(h[e], l[e], v[e], sh[p], sl[p], sv[p], keep_min);
        }
      }
    }
    for (int j = min(k >> 1, 16 * E); j >= E; j >>= 1) {
      const int m = j / E;
      merge_shuffle<E>(h, l, v, m, ((lane & m) == 0) == asc);
    }
    merge_registers<E>(h, l, v, asc);
  }

  if (ROW_BLOCK) __syncthreads(); else __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = pad(q * E + e);
    sh[p] = h[e];
    sl[p] = l[e];
    sv[p] = v[e];
  }
  if (ROW_BLOCK) __syncthreads(); else __syncwarp();
  store_rows(hi_out, lo_out, val_out, base, n, sh, sl, sv, i0, step, vec);
}

template <int E, bool ROW_BLOCK, int MAX_THREADS>
int launch(const void* hi, const void* lo, const void* val, void* hi_out,
           void* lo_out, void* val_out, long long r, int c,
           int rows_per_block, int threads, long long smem, bool vec,
           cudaStream_t stream) {
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  auto kernel = bitonic_kernel<E, ROW_BLOCK, MAX_THREADS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (r + rows_per_block - 1) / rows_per_block;
  kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      (const long long*)hi, (const long long*)lo, (const int*)val,
      (long long*)hi_out, (long long*)lo_out, (int*)val_out, r, c, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// hi, lo: (r, c) int64; val: (r, c) int32; c a power of two; outputs alike.
// The geometry (rows a block, threads a row, slots a thread, shared bytes)
// comes from kernels/bitonic.py:launch_geometry; one that this file has no
// kernel for returns cudaErrorInvalidValue.
extern "C" int repro_sort_rows(const void* hi, const void* lo, const void* val,
                               void* hi_out, void* lo_out, void* val_out,
                               long long r, int c, int rows_per_block,
                               int threads_per_row, int elems,
                               long long smem, void* stream) {
  if (r <= 0 || c <= 0) return (int)cudaGetLastError();
  const int threads = rows_per_block * threads_per_row;
  const bool row_block = threads_per_row > 32;
  if ((c & (c - 1)) || elems < 1 || elems > 32 || (elems & (elems - 1)) ||
      threads_per_row * elems != c || threads % 32 ||
      (row_block ? rows_per_block != 1 : threads > kWarpBlock) ||
      smem < (long long)threads / 32 * 3 * 33 * elems * 4)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(hi) && aligned16(lo) && aligned16(val) &&
                   aligned16(hi_out) && aligned16(lo_out) &&
                   aligned16(val_out);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LAUNCH(E, RB, MT)                                             \
  launch<E, RB, MT>(hi, lo, val, hi_out, lo_out, val_out, r, c,             \
                    rows_per_block, threads, smem, vec, s)
  if (row_block) {
    if (elems != 32) return (int)cudaErrorInvalidValue;
    // up to 4 warps a row may keep every register they need; 16 get 128
    return threads <= 128 ? REPRO_LAUNCH(32, true, 128)
                          : REPRO_LAUNCH(32, true, 512);
  }
  switch (elems) {
    case 1: return REPRO_LAUNCH(1, false, kWarpBlock);
    case 2: return REPRO_LAUNCH(2, false, kWarpBlock);
    case 4: return REPRO_LAUNCH(4, false, kWarpBlock);
    case 8: return REPRO_LAUNCH(8, false, kWarpBlock);
    case 16: return REPRO_LAUNCH(16, false, kWarpBlock);
    default: return REPRO_LAUNCH(32, false, kWarpBlock);
  }
#undef REPRO_LAUNCH
}
