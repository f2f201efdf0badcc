#!/usr/bin/env python3
"""Where the RMI and histogram kernels' time goes: each committed source
(``src/repro_torch/csrc/{rmi,histogram}.cu``) against variants of
itself and, given ``--parent DIR`` (an unpacked earlier tree of this
repository), against that tree's sources, on one CUDA card.

RMI variants, each the committed source with one change, built with the
port's nvcc flags into its own library:

- ``kernel``        — as committed: the packed 32-byte leaf row, two
  16-byte loads, one record a thread, its key words streamed;
- ``two_records`` / ``four_records`` / ``eight_records`` — the
  several-records design: R records a thread, 16-byte loads of the key
  words where aligned, all R row gathers issued before any id, one
  16-byte store of four ids;
- ``threads_128`` / ``_512`` / ``_1024`` — blocks of that many threads,
  not 256;
- ``words_ldg``     — the key words loaded through the read-only cache
  (``__ldg``) in place of streaming loads (``__ldcs``);
- ``store_cs``      — the ids stored as streaming (``__stcs``);
- ``pair_one``      — the two halves of a row loaded by the two lanes of
  a pair in one instruction (one L1 wavefront a row where one lane's two
  16-byte loads take two), swapped by shuffles;
- ``ldcg_one``      — rows loaded past the L1 (``__ldcg``);
- ``split_one``     — rows read as seven scalar loads from split (L, 5)
  f32 and (L, 2) int64 tables, one record a thread: the first design's
  loads;
- ``split_four``    — split tables, four records a thread.

Each is timed cold (CUDA events, median of 20 after a 256 MB write that
evicts the L2) at 1,441,792 keys, 2**20 buckets and 25,000 leaves, on
uniform and skewed keys, in generation order and in the main path's
routed order (two range partitions, each shuffled), and at a 64-key
serving batch (10,000,000 buckets); variants run in turns forward then
backward.  ``(x)`` marks a time whose ids differ from the plain version's.

Histogram: the committed kernel at 8,192, 58,113, 116,224, 464,896 and
929,792 bins in every strategy and cluster size that holds the bins
(``shared c``: a private histogram a block reduced over clusters of c;
``split c``: the bins split over clusters of c; ``global``); then, at
8,192, 58,113 and 2**20 bins in the committed geometry, source variants
— ``match_popc`` (``__match_any_sync`` per slot, the group's leader
adds ``__popc``), ``no_aggregation`` (no all-equal step),
``one_block_an_sm`` / ``four_blocks_an_sm`` (the cluster strategies'
grid), ``shared_four_ids`` (4 ids a lane a step in the cluster
strategies, not 8), ``global_one_id`` / ``_two_ids`` / ``_eight_ids``
(ids a lane a step in the global strategy, not 4), ``global_16_an_sm``
(its grid cap at 16 blocks an SM, not 8), ``threads_128`` / ``_512``
(blocks of that many threads, not 256), ``ids_cs`` (ids by streaming
loads) and ``threads_512_ids_cs``.  Ids: the RMI-routed ids of a
main-path batch, uniform ids and all-equal ids, 1,441,792 each.
Run from the repository root on a machine with the card and the CUDA
toolkit:

    python3 experiments/rmi_histogram_variants.py [--parent DIR]
"""

import collections
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import rmi as rmi_lib  # noqa: E402
from repro_torch.core.learned_sort import Q_RES  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.kernels import build, encode, histogram, rmi  # noqa: E402

N = 1_441_792  # keys of a main-path batch
HALF = 666_896  # records of its first partition
N_LEAF = 25_000
SERVE_BUCKETS = 10_000_000

_GATHER = (
    "  const uint4* row = table + 2 * leaf_of(h, l, m);\n"
    "  out[i] = bucket(h, l, __ldg(row), __ldg(row + 1), m);\n"
)
# the row from split tables laid out by split_tables() below: (L, 5) f32,
# then (L, 2) int64 at the next 32-byte boundary
_SPLIT_ROW = (
    "  const float* f = reinterpret_cast<const float*>(table) + 5 * leaf;\n"
    "  const long long* u = reinterpret_cast<const long long*>(\n"
    "      reinterpret_cast<const char*>(table) +\n"
    "      (20LL * m.n_leaf + 31) / 32 * 32) + 2 * leaf;\n"
    "  const uint4 a = make_uint4(__float_as_uint(__ldg(f)), __float_as_uint(__ldg(f + 1)),\n"
    "                             __float_as_uint(__ldg(f + 2)), __float_as_uint(__ldg(f + 3)));\n"
    "  const uint4 b = make_uint4(__float_as_uint(__ldg(f + 4)), (unsigned)__ldg(u),\n"
    "                             (unsigned)__ldg(u + 1), 0u);\n"
)
_SPLIT_GATHER = (
    "  const int leaf = leaf_of(h, l, m);\n" + _SPLIT_ROW
    + "  out[i] = bucket(h, l, a, b, m);\n"
)
_LDCG_GATHER = _GATHER.replace("__ldg(", "__ldcg(")
# lane 2p loads half 0 and lane 2p+1 half 1 of one row per instruction;
# every lane of a warp takes part in the shuffles, so none exits early
_PAIR_BODY = (
    "  const bool live = i < n;\n"
    "  const uint32_t h = live ? (uint32_t)__ldcs(hi + i) : 0u;\n"
    "  const uint32_t l = live ? (uint32_t)__ldcs(lo + i) : 0u;\n"
    "  const unsigned odd = threadIdx.x & 1;\n"
    "  const int own = leaf_of(h, l, m);\n"
    "  const int other = __shfl_xor_sync(0xffffffffu, own, 1);\n"
    "  const uint4 r1 = __ldg(table + 2 * (odd ? other : own) + odd);\n"
    "  const uint4 r2 = __ldg(table + 2 * (odd ? own : other) + odd);\n"
    "  const uint4 send = odd ? r1 : r2;\n"
    "  uint4 recv;\n"
    "  recv.x = __shfl_xor_sync(0xffffffffu, send.x, 1);\n"
    "  recv.y = __shfl_xor_sync(0xffffffffu, send.y, 1);\n"
    "  recv.z = __shfl_xor_sync(0xffffffffu, send.z, 1);\n"
    "  recv.w = __shfl_xor_sync(0xffffffffu, send.w, 1);\n"
    "  if (live) out[i] = bucket(h, l, odd ? recv : r1, odd ? r2 : recv, m);\n"
)
_BODY = (
    "  if (i >= n) return;\n"
    "  // words are read once: streaming loads leave the caches to the rows\n"
    "  const uint32_t h = (uint32_t)__ldcs(hi + i), l = (uint32_t)__ldcs(lo + i);\n"
    + _GATHER
)
# the several-records design measured beside the committed kernel: R
# records a thread, 16-byte loads of the words where aligned, all R row
# gathers issued before any id, one 16-byte store of four ids
_SEVERAL_KERNEL = """// kVec: hi, lo and out are 16-byte aligned, so a full group moves its
// words and ids by 16-byte accesses.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    rmi_kernel(const long long* __restrict__ hi,
               const long long* __restrict__ lo, long long n, Model m,
               const uint4* __restrict__ table, int* __restrict__ out) {{
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * {R};
  if (i0 >= n) return;
  const bool full = n - i0 >= {R};
  uint32_t h[{R}], l[{R}];
  if (kVec && {R} % 2 == 0 && full) {{
#pragma unroll
    for (int r = 0; r + 1 < {R}; r += 2) {{
      longlong2 a = __ldg(reinterpret_cast<const longlong2*>(hi + i0 + r));
      longlong2 b = __ldg(reinterpret_cast<const longlong2*>(lo + i0 + r));
      h[r] = (uint32_t)a.x;
      h[r + 1] = (uint32_t)a.y;
      l[r] = (uint32_t)b.x;
      l[r + 1] = (uint32_t)b.y;
    }}
  }} else {{
#pragma unroll
    for (int r = 0; r < {R}; ++r) {{
      bool in = i0 + r < n;
      h[r] = in ? (uint32_t)__ldg(hi + i0 + r) : 0u;
      l[r] = in ? (uint32_t)__ldg(lo + i0 + r) : 0u;
    }}
  }}
  uint4 a[{R}], b[{R}];
#pragma unroll
  for (int r = 0; r < {R}; ++r) {{
    const uint4* row = table + 2 * leaf_of(h[r], l[r], m);
    a[r] = __ldg(row);
    b[r] = __ldg(row + 1);
  }}
  int id[{R}];
#pragma unroll
  for (int r = 0; r < {R}; ++r) id[r] = bucket(h[r], l[r], a[r], b[r], m);
  if (kVec && {R} % 4 == 0 && full) {{
#pragma unroll
    for (int r = 0; r + 3 < {R}; r += 4)
      *reinterpret_cast<int4*>(out + i0 + r) =
          make_int4(id[r], id[r + 1], id[r + 2], id[r + 3]);
  }} else {{
#pragma unroll
    for (int r = 0; r < {R}; ++r)
      if (i0 + r < n) out[i0 + r] = id[r];
  }}
}}

"""
_SEVERAL_LAUNCH = (
    "    const long long groups = (n + {R} - 1) / {R};\n"
    "    const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);\n"
    "    const bool vec =\n"
    "        ((uintptr_t)hi | (uintptr_t)lo | (uintptr_t)out) % 16 == 0;\n"
    "    cudaStream_t s = (cudaStream_t)stream;\n"
    "    const long long* h = (const long long*)hi;\n"
    "    const long long* l = (const long long*)lo;\n"
    "    const uint4* t = (const uint4*)table;\n"
    "    if (vec)\n"
    "      rmi_kernel<true><<<blocks, kThreads, 0, s>>>(h, l, n, m, t, (int*)out);\n"
    "    else\n"
    "      rmi_kernel<false><<<blocks, kThreads, 0, s>>>(h, l, n, m, t, (int*)out);\n"
)
_KERNEL_FN = "__global__ void __launch_bounds__(kThreads)\n    rmi_kernel("
_LAUNCH = (
    "    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);\n"
    "    rmi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(\n"
    "        (const long long*)hi, (const long long*)lo, n, m, (const uint4*)table,\n"
    "        (int*)out);\n"
)
# the gathers of the several-records kernel, from split tables
_SEVERAL_GATHER = (
    "    const uint4* row = table + 2 * leaf_of(h[r], l[r], m);\n"
    "    a[r] = __ldg(row);\n"
    "    b[r] = __ldg(row + 1);\n"
)
_SEVERAL_SPLIT = (
    "    const int leaf = leaf_of(h[r], l[r], m);\n"
    + _SPLIT_ROW.replace("  const uint4 a =", "  a[r] =").replace(
        "  const uint4 b =", "  b[r] =").replace("\n  ", "\n    ").replace(
        "  const float*", "    const float*", 1)
)


def _several(src: str, r: int, split: bool = False) -> list:
    """Edits that swap the committed kernel and its launch for the
    several-records design at r records a thread."""
    fn = src[src.index(_KERNEL_FN):src.index("}  // namespace")]
    edits = [(fn, _SEVERAL_KERNEL.format(R=r)), (_LAUNCH, _SEVERAL_LAUNCH.format(R=r))]
    if split:
        edits.append((_SEVERAL_GATHER, _SEVERAL_SPLIT))
    return edits


_THREADS = "constexpr int kThreads = 256;"


def _threads(t: int) -> tuple:
    return (_THREADS, f"constexpr int kThreads = {t};")


def rmi_variants(src: str) -> dict:
    return {
        "kernel": [],
        "threads_128": [_threads(128)],
        "threads_512": [_threads(512)],
        "threads_1024": [_threads(1024)],
        "words_ldg": [(_BODY, _BODY.replace("__ldcs(hi", "__ldg(hi").replace(
            "__ldcs(lo", "__ldg(lo"))],
        "store_cs": [("  out[i] = bucket(h, l, __ldg(row), __ldg(row + 1), m);",
                      "  __stcs(out + i, bucket(h, l, __ldg(row), __ldg(row + 1), m));")],
        "two_records": _several(src, 2),
        "four_records": _several(src, 4),
        "eight_records": _several(src, 8),
        "pair_one": [(_BODY, _PAIR_BODY)],
        "ldcg_one": [(_GATHER, _LDCG_GATHER)],
        "split_one": [(_GATHER, _SPLIT_GATHER)],
        "split_four": _several(src, 4, split=True),
    }


_PER_LANE = "constexpr int kPerLane = S == kGlobal ? 4 : 8;"
_GLOBAL_16 = ("constexpr int kGlobalBlocksPerSm = 8;",
              "constexpr int kGlobalBlocksPerSm = 16;")


def _per_lane(global_ids: int, cluster_ids: int) -> str:
    return f"constexpr int kPerLane = S == kGlobal ? {global_ids} : {cluster_ids};"


def hist_variants(src: str) -> dict:
    step = src[src.index("    const int first = __shfl_sync("):src.index(
        "  if (S == kGlobal) {\n")]
    per_id = (
        "#pragma unroll\n"
        "    for (int r = 0; r < kPerLane<S>; ++r)\n"
        "      if (v[r] >= 0) add<S>(bins, slice, out, v[r], 1);\n  }\n"
    )
    match = (
        "#pragma unroll\n"
        "    for (int r = 0; r < kPerLane<S>; ++r) {\n"
        "      const unsigned peers = __match_any_sync(0xffffffffu, v[r]);\n"
        "      if (v[r] >= 0 && lane == (unsigned)(__ffs(peers) - 1))\n"
        "        add<S>(bins, slice, out, v[r], __popc(peers));\n"
        "    }\n  }\n"
    )
    return {
        "match_popc": [(step, match)],
        "no_aggregation": [(step, per_id)],
        "one_block_an_sm": [("constexpr int kBlocksPerSm = 2;",
                             "constexpr int kBlocksPerSm = 1;")],
        "four_blocks_an_sm": [("constexpr int kBlocksPerSm = 2;",
                               "constexpr int kBlocksPerSm = 4;")],
        "shared_four_ids": [(_PER_LANE, _per_lane(4, 4))],
        "global_one_id": [(_PER_LANE, _per_lane(1, 8))],
        "global_two_ids": [(_PER_LANE, _per_lane(2, 8))],
        "global_eight_ids": [(_PER_LANE, _per_lane(8, 8))],
        "global_16_an_sm": [_GLOBAL_16],
        "threads_128": [_threads(128)],
        "threads_512": [_threads(512)],
        "ids_cs": [("__ldg(ids + i)", "__ldcs(ids + i)")],
        "threads_512_ids_cs": [_threads(512), ("__ldg(ids + i)", "__ldcs(ids + i)")],
    }


# the C signatures of the parent tree's entries (one table pointer more
# for RMI; no geometry for the histogram)
_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)
PARENT_SIGNATURES = {
    "repro_rmi_bucket": [_P, _P, _LL, _U, _U, _F, _F, _F, _I, _P, _P, _I, _P, _P],
    "repro_histogram": [_P, _LL, _I, _P, _P],
}


def compile_variants(tmp: str, source: str, variants: dict, entry: str,
                     parent: "str | None" = None) -> dict:
    """name -> entry point of each variant built into its own library;
    with ``parent``, also ``"parent"``: that tree's source as it is."""
    src = open(os.path.join(build.CSRC, source)).read()
    jobs = {}
    for name, edits in variants.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"{name}: anchor not found in {source}")
            s = s.replace(old, new, 1)
        jobs[name] = s
    if parent:
        jobs["parent"] = open(os.path.join(
            parent, "src", "repro_torch", "csrc", source)).read()
    nvcc = build._nvcc()
    procs = {}
    for name, text in jobs.items():
        cu, so = (os.path.join(tmp, f"{source}.{name}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        res = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"{source} {name}: {'; '.join(res)}", flush=True)
        fn = getattr(ctypes.CDLL(so), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = (PARENT_SIGNATURES[entry] if name == "parent"
                       else build._SIGNATURES[entry][1])
        fns[name] = fn
    return fns


def cold_ms(fn, reps: int = 20) -> float:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def split_tables(model) -> torch.Tensor:
    """(L, 5) f32 then (L, 2) int64 from the next 32-byte boundary, as
    one int32 buffer (the split variants' table argument)."""
    n_leaf = model.n_leaf
    off = -(-n_leaf * 20 // 32) * 8  # int32 words
    buf = torch.zeros(off + n_leaf * 4, dtype=torch.int32)
    buf[: n_leaf * 5] = model.ftable().cpu().contiguous().view(torch.int32).reshape(-1)
    buf[off:] = model.utable().cpu().contiguous().view(torch.int32).reshape(-1)
    return buf.to(model.device)


def rmi_cases(dev):
    """(label, model, hi, lo, n_buckets) at the main path's shapes and a
    serving batch."""
    order = np.concatenate([
        np.random.default_rng(2).permutation(HALF),
        HALF + np.random.default_rng(3).permutation(N - HALF),
    ])
    keys = {
        "uniform": gensort.uniform_keys(N, seed=1),
        "skewed": gensort.skewed_keys(N, seed=1, start_idx=N),
    }
    for dist, k in keys.items():
        model = rmi_lib.fit(k[:: N // (4 * N_LEAF)], n_leaf=N_LEAF).to(dev)
        kv = np.ascontiguousarray(k).view("S10").reshape(-1)
        for key_order, kk in (("generation", k),
                              ("routed", k[np.argsort(kv, kind="stable")][order])):
            hi, lo = encode.encode_cuda(torch.from_numpy(kk[:, :8].copy()).to(dev))
            yield f"L={N_LEAF} {dist} {key_order}", model, hi, lo, Q_RES
        if dist == "skewed":
            hi, lo = encode.encode_cuda(torch.from_numpy(k[:64, :8].copy()).to(dev))
            yield "serving 64 keys", model, hi, lo, SERVE_BUCKETS


def run_rmi(fns: dict, dev) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for label, model, hi, lo, n_buckets in rmi_cases(dev):
        want = rmi.rmi_bucket_plain(model, hi, lo, n_buckets)
        ft, ut = model.ftable().contiguous(), model.utable().contiguous()
        tables = {"packed": [model.kernel_table], "split": [split_tables(model)],
                  "parent": [ft, ut]}
        times = collections.defaultdict(list)
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                kind = name if name == "parent" else (
                    "split" if name.startswith("split") else "packed")
                out = torch.empty_like(want)
                args = (hi.data_ptr(), lo.data_ptr(), hi.shape[0],
                        int(model.min_hi), int(model.min_lo),
                        float(model.inv_range), float(model.root_slope),
                        float(model.root_intercept), n_buckets,
                        *(t.data_ptr() for t in tables[kind]), model.n_leaf,
                        out.data_ptr(), stream)
                launch = lambda: fns[name](*args)  # noqa: E731
                build.check(launch(), name)
                torch.cuda.synchronize()
                ok = torch.equal(out, want)
                times[name].append(f"{cold_ms(launch):.4f}{'' if ok else '(x)'}")
        print(f"rmi {label}: " + ", ".join(
            f"{n} {'/'.join(t)} ms" for n, t in times.items()), flush=True)


def hist_ids(dev) -> dict:
    k = gensort.skewed_keys(N, seed=1, start_idx=N)
    model = rmi_lib.fit(k[:: N // (4 * N_LEAF)], n_leaf=N_LEAF).to(dev)
    hi, lo = encode.encode_cuda(torch.from_numpy(k[:, :8].copy()).to(dev))
    rng = np.random.default_rng(4)
    return lambda n_bins: {
        "routed": rmi.rmi_bucket_cuda(model, hi, lo, n_bins),
        "uniform": torch.from_numpy(
            rng.integers(0, n_bins, size=N, dtype=np.int32)).to(dev),
        "equal": torch.full((N,), n_bins // 3, dtype=torch.int32, device=dev),
    }


def time_hist(fn, ids, n_bins, geo) -> str:
    """Cold ms of one launch; ``geo`` None: the parent's entry point."""
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n_bins, dtype=torch.int32, device=ids.device)
    shape = () if geo is None else (
        histogram.STRATEGIES.index(geo.strategy), geo.cluster, geo.block_bins,
        geo.slice)
    args = (ids.data_ptr(), ids.shape[0], n_bins, *shape, out.data_ptr(), stream)
    build.check(fn(*args), "histogram")
    torch.cuda.synchronize()
    ok = torch.equal(out, histogram.histogram_plain(ids, n_bins))
    return f"{cold_ms(lambda: fn(*args)):.4f}{'' if ok else '(x)'}"


def run_histogram(fns: dict, dev) -> None:
    make = hist_ids(dev)
    committed = build.library().repro_histogram
    max_bins = histogram.max_block_bins()
    G = histogram.Geometry
    for n_bins in (8192, 58_113, 116_224, 464_896, 929_792):
        geos = {}
        for c in (1, 2, 4, 8, 16):
            part = -(-n_bins // c)
            if n_bins <= max_bins:
                geos[f"shared {c}"] = G("shared", c, n_bins, part)
            if part <= max_bins:
                geos[f"split {c}"] = G("split", c, part, part)
        geos["global"] = G("global", 0, 0, 0)
        for kind, t in make(n_bins).items():
            cells = [f"{name} {time_hist(committed, t, n_bins, g)}"
                     for name, g in geos.items()]
            if "parent" in fns:
                cells.append(f"parent {time_hist(fns['parent'], t, n_bins, None)}")
            print(f"histogram ({N}, {n_bins}) {kind}: " + ", ".join(cells) + " ms",
                  flush=True)
    for n_bins in (8192, 58_113, 1 << 20):
        geo = histogram.launch_geometry(n_bins, max_bins)
        for kind, t in make(n_bins).items():
            cells = [f"{name} {time_hist(fn, t, n_bins, None if name == 'parent' else geo)}"
                     for name, fn in fns.items()]
            print(f"histogram ({N}, {n_bins}) {kind}, {geo}: kernel "
                  f"{time_hist(committed, t, n_bins, geo)}, " + ", ".join(cells)
                  + " ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("rmi_histogram_variants: no CUDA device", file=sys.stderr)
        return 2
    parent = sys.argv[2] if sys.argv[1:2] == ["--parent"] else None
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        rmi_src = open(os.path.join(build.CSRC, "rmi.cu")).read()
        rmi_fns = compile_variants(tmp, "rmi.cu", rmi_variants(rmi_src),
                                   "repro_rmi_bucket", parent)
        src = open(os.path.join(build.CSRC, "histogram.cu")).read()
        hist_fns = compile_variants(tmp, "histogram.cu", hist_variants(src),
                                    "repro_histogram", parent)
        run_rmi(rmi_fns, dev)
        run_histogram(hist_fns, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
