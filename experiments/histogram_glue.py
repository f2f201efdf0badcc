#!/usr/bin/env python3
"""The partition glue's bucket counts on one CUDA card: the histogram
kernel (``src/repro_torch/csrc/histogram.cu``) against the
``scatter_add_`` count the glue used before it, at the shapes the
benchmark's cells give the count.

Ids, all in a seeded random order:

- ``route 4`` / ``route 5``: 2^28 RMI ids of skewed gensort keys at 4
  buckets (a rank's quarter routed to 4 ranks), and the same with a
  tenth of them set to bin 4 (the router's discard bucket);
- ``mesh 2^20``: 2^29 ids into 2^20 bins, four quarters each of 2^26
  real ids then 2^26 of bin 2^20 - 1 (a rank's received rows: each
  sender's row ends in its SENTINEL padding, which all lands in the last
  bucket); the real ids are the RMI ids of skewed keys, or uniform;
- ``hbm``: 2^25 to 2^28 RMI ids of uniform or skewed keys at
  ``learned_sort.grid_shape``'s bins (2^16 to 2^19), as ``sort_device``
  counts them in the one-card cells.

Each is timed cold (CUDA events, median after a 256 MB L2-evicting
write): ``scatter_add_`` (an int64 copy of the ids, a ones tensor, a
scatter-add into zeros), the kernel's entry point at the committed
geometry, and each source variant below built into its own library;
``ops.bucket_histogram`` (the wrapper the glue calls) is timed once
more at the end.  ``(x)`` marks counts that differ from
``scatter_add_``'s.  Variants:

- ``no_cache``: the global strategy without its cache, one global
  atomic an add (the kernel as it was before the glue called it);
- ``cache_1k`` / ``cache_4k``: a cache of 1,024 / 4,096 bins a block,
  not 2,048;
- ``carry``: a warp's all-equal steps of one id add once when the id
  changes or the warp ends, not once a step;
- ``ballot``: a step that is not all-equal counts the lanes equal to
  lane 0's id with one ballot and one add, then adds the rest one by one.

Run from the repository root on a machine with the card and the CUDA
toolkit (~3 minutes):

    python3 experiments/histogram_glue.py
"""

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from experiments.rmi_histogram_variants import cold_ms, compile_variants  # noqa: E402
from perfbench import gensort_keys, harness  # noqa: E402
from repro_torch.core import learned_sort  # noqa: E402
from repro_torch.kernels import build, histogram, ops  # noqa: E402

_STEP_ADD = (
    "    if (__all_sync(0xffffffffu, same && v[0] == first) && first >= 0) {\n"
    "      if (lane == 0) add<S>(bins, slice, out, first, kWarpStep<S>);\n"
    "      continue;\n"
    "    }\n"
)
_STEP_CARRY = (
    "    if (__all_sync(0xffffffffu, same && v[0] == first) && first >= 0) {\n"
    "      if (first != run_id) {\n"
    "        if (lane == 0 && run_count) add<S>(bins, slice, out, run_id, run_count);\n"
    "        run_id = first;\n"
    "        run_count = 0;\n"
    "      }\n"
    "      run_count += kWarpStep<S>;\n"
    "      continue;\n"
    "    }\n"
)
_LOOP = "  for (long long base = warp * kWarpStep<S>; base < n; base += stride) {\n"
_PER_ID = (
    "#pragma unroll\n"
    "    for (int r = 0; r < kPerLane<S>; ++r)\n"
    "      if (v[r] >= 0) add<S>(bins, slice, out, v[r], 1);\n"
)
_BALLOT = (
    "#pragma unroll\n"
    "    for (int r = 0; r < kPerLane<S>; ++r) {\n"
    "      const int f = __shfl_sync(0xffffffffu, v[r], 0);\n"
    "      const unsigned eq = __ballot_sync(0xffffffffu, v[r] == f);\n"
    "      if (v[r] >= 0 && (v[r] != f || lane == 0))\n"
    "        add<S>(bins, slice, out, v[r], v[r] == f ? __popc(eq) : 1);\n"
    "    }\n"
)
_CACHED_ADD = (
    "    int* tag = bins;  // -1: the slot is free\n"
    "    const int slot = (int)(((unsigned)id * 2654435761u) >> (32 - kCacheLog2));\n"
    "    int held = *(volatile int*)(tag + slot);\n"
    "    if (held < 0) {\n"
    "      held = atomicCAS(tag + slot, -1, id);\n"
    "      if (held < 0) held = id;\n"
    "    }\n"
    "    if (held == id)\n"
    "      atomicAdd(bins + kCacheSlots + slot, count);\n"
    "    else\n"
    "      atomicAdd(out + id, count);\n"
)
_CACHE_ZERO = (
    "  } else {\n"
    "    for (int b = threadIdx.x; b < kCacheSlots; b += kThreads) {\n"
    "      bins[b] = -1;\n"
    "      bins[kCacheSlots + b] = 0;\n"
    "    }\n"
    "    __syncthreads();\n"
    "  }\n"
)
_CACHE_FLUSH = (
    "  if (S == kGlobal) {\n"
    "    __syncthreads();\n"
    "    for (int b = threadIdx.x; b < kCacheSlots; b += kThreads) {\n"
    "      const int c = bins[kCacheSlots + b];\n"
    "      if (c) atomicAdd(out + bins[b], c);\n"
    "    }\n"
    "    return;\n"
    "  }\n"
)
_CACHE_SMEM = "2 * kCacheSlots * sizeof(int), s>>>("
_LOG2 = "constexpr int kCacheLog2 = 11;"
# the global strategy as it was before its cache: one global atomic an add
NO_CACHE = [
    (_CACHED_ADD, "    atomicAdd(out + id, count);\n"),
    (_CACHE_ZERO, "  }\n"),
    (_CACHE_FLUSH, "  if (S == kGlobal) return;\n"),
    (_CACHE_SMEM, "0, s>>>("),
]
CARRY = [
    (_LOOP, "  int run_id = -1, run_count = 0;  // the warp's pending all-equal run\n"
     + _LOOP),
    (_STEP_ADD, _STEP_CARRY),
    (_CACHE_FLUSH,
     "  if (lane == 0 && run_count) add<S>(bins, slice, out, run_id, run_count);\n"
     + _CACHE_FLUSH),
]
VARIANTS = {
    "no_cache": NO_CACHE,
    "cache_1k": [(_LOG2, "constexpr int kCacheLog2 = 10;")],
    "cache_4k": [(_LOG2, "constexpr int kCacheLog2 = 12;")],
    "carry": CARRY,
    "ballot": [(_PER_ID, _BALLOT)],
}


def scatter_add_count(ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The count the glue made before the kernel."""
    counts = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(
        0, ids.to(torch.int64), torch.ones_like(ids, dtype=torch.int32))


_models: dict = {}


def rmi_ids(config: str, n: int, n_bins: int, seed: int, dev) -> torch.Tensor:
    """RMI ids at ``n_bins`` of ``n`` keys of the configuration, drawn as
    the benchmark draws them, by the model the benchmark trains."""
    with open(os.path.join(ROOT, "perfbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = gensort_keys.random_records(n, cfg, gen, dev)
    if config not in _models:
        _models[config] = harness.train_model(cfg, dev)[0]
    model = _models[config]
    hi, lo = ops.encode_keys(keys)
    del keys
    ids = ops.rmi_bucket(model, hi, lo, n_bins)
    del hi, lo
    torch.cuda.empty_cache()
    return ids


def cases(dev):
    """(label, ids, n_bins) of each shape, made one at a time."""
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    route = rmi_ids("gensort-skew", 1 << 28, 4, 1, dev)
    yield "route 4, skewed keys", route, 4
    discard = torch.rand(route.shape[0], generator=g, device=dev) < 0.1
    yield "route 5, a tenth discarded", torch.where(discard, 4, route), 5
    del route, discard
    for kind in ("skewed", "uniform"):
        if kind == "skewed":
            real = rmi_ids("gensort-skew", 1 << 28, 1 << 20, 2, dev)
        else:
            real = torch.randint(0, 1 << 20, (1 << 28,), generator=g,
                                 device=dev, dtype=torch.int32)
        ids = torch.full((4, 1 << 27), (1 << 20) - 1, dtype=torch.int32, device=dev)
        ids[:, : 1 << 26] = real.view(4, 1 << 26)
        del real
        yield f"mesh 2^20, {kind} real ids then padding runs", ids.view(-1), 1 << 20
        del ids
    for config in ("gensort-uniform", "gensort-skew"):
        for log2n in (25, 26, 27, 28):
            n_bins, _ = learned_sort.grid_shape(1 << log2n)
            yield (f"hbm 2^{log2n}, {config}",
                   rmi_ids(config, 1 << log2n, n_bins, 3 + log2n, dev), n_bins)


def time_entry(fn, ids, n_bins, geo, want) -> str:
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n_bins, dtype=torch.int32, device=ids.device)
    args = (ids.data_ptr(), ids.shape[0], n_bins,
            histogram.STRATEGIES.index(geo.strategy), geo.cluster,
            geo.block_bins, geo.slice, out.data_ptr(), stream)
    build.check(fn(*args), "histogram")
    torch.cuda.synchronize()
    ok = torch.equal(out, want)
    return f"{cold_ms(lambda: fn(*args), reps=10):.4f}{'' if ok else '(x)'}"


def main() -> int:
    if not torch.cuda.is_available():
        print("histogram_glue: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    max_bins = histogram.max_block_bins()
    with tempfile.TemporaryDirectory() as tmp:
        fns = compile_variants(tmp, "histogram.cu", VARIANTS, "repro_histogram")
        fns = {"kernel": build.library().repro_histogram, **fns}
        for label, ids, n_bins in cases(dev):
            geo = histogram.launch_geometry(n_bins, max_bins)
            want = scatter_add_count(ids, n_bins)
            old = cold_ms(lambda: scatter_add_count(ids, n_bins), reps=5)
            cells = [f"{name} {time_entry(fn, ids, n_bins, geo, want)}"
                     for name, fn in fns.items()]
            ops.reset_launches()
            got = ops.bucket_histogram(ids, n_bins)
            launched = dict(ops.bucket_histogram.strategy_launches)
            wrapped = cold_ms(lambda: ops.bucket_histogram(ids, n_bins), reps=10)
            ok = "" if torch.equal(got, want) else "(x)"
            print(f"{label} ({ids.shape[0]} ids, {n_bins} bins, {geo.strategy}): "
                  f"scatter_add_ {old:.4f}, " + ", ".join(cells)
                  + f", ops.bucket_histogram {wrapped:.4f}{ok} ms; "
                  f"launches {launched}", flush=True)
            del ids, want, got
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
