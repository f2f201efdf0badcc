"""One run of a cell on several cards: one process a rank.

``run.py`` hands a cell whose ``chips`` is over 1 to :func:`main` before
it touches a card.  The parent builds (or loads) the program's kernel
library once, then starts one process a rank through the program's own
launcher, ``repro_torch.launch.mesh.spawn`` (``RANK`` and ``WORLD_SIZE``
as ``torchrun`` sets them, a hard timeout, every rank killed as soon as
one fails).  Rank ``r`` owns ``cuda:r``, joins an NCCL process group
(``launch.mesh.initialize_multiprocess``, a ``file://`` store in
``TMPDIR``) and the program's 1-D data mesh (``make_data_mesh``), and
keeps a gloo group of its own for the harness's barriers and gathers,
so that every NCCL kernel on a card is the program's.  Each rank writes
its log to its standard output; the parent relays every rank's log to
its standard error and prints rank 0's result line last.

A rank (:func:`run_rank`), in order:

1. makes its input on its card from the seed: every record of its own
   contiguous share of the file, ``[r * F / W, (r + 1) * F / W)``, in
   an order drawn from the seed, as a node of a cluster sort holds the
   slice it stores (under gensort ``-s`` the file's largest spike, its
   second half, lies on the last ranks alone); every call sorts the
   whole share, so a call sorts the whole file;
2. trains the model with the program's ``rmi.fit`` on the
   configuration's whole-file sample (``harness.train_model``); every
   rank's leaf-table digest must agree;
3. builds the program's ``core.distributed.make_sort_fn(mesh,
   ("data",), model, n)`` for its share and calls it once;
4. runs the window.  A call is ``kernels.ops.encode_keys(keys)`` ->
   ``fn(hi, lo, val)``, ``val = r * n + arange(n)`` made once, ->
   ``torch.cuda.synchronize()`` -> a barrier of every rank: it ends
   when every rank's answer is ready.  Rank 0's clock times it from the
   barrier before it (the window's first, or the last call's); rank 0's
   word on the window's end rides on the barrier.  After the call the
   seed drew (:func:`checked_call`) the clock stops while every rank
   copies the valid prefix of its answer to the host (a
   ``perfbench.pause`` span, which the trace cuts out), so the kept
   answer takes none of the card's memory and none of the window.

After the window each rank reads its peak, frees the model and the
sort, and the distributed reference (:mod:`mesh_reference`) checks the
answers of the call the seed drew and of the last call.  Rank 0 gathers
every rank's numbers and reads the metrics (``perfbench/metrics``) from
a :class:`MeshContext`.

``setup_s`` runs from the parent's start (``run.T_START``) to rank 0's
window start; both are ``time.perf_counter()``, the system-wide
monotonic clock on Linux, so they compare across processes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from perfbench import gensort_keys, harness, manifest, mesh_reference, stats, trace, traffic

# every rank, from its start to its result line, the first run of a
# checkout included: the parent builds the kernel library before it
RANK_TIMEOUT_S = 300.0
# how long a collective waits for a rank that has failed
GROUP_TIMEOUT_S = 240.0
SPEC_ENV = "PERFBENCH_MESH_SPEC"
STARTED_ENV = "PERFBENCH_RANK_STARTED"  # the rank's clock before its imports


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass
class RankRun:
    """What rank 0 gathers from each rank after the check."""

    device_name: str
    peak_bytes: int  # torch.cuda.max_memory_allocated over the window
    base_bytes: int  # torch.cuda.memory_allocated at its start
    setup_peak_bytes: int
    n_valid: int  # records in the rank's answers over the window
    sort_records: int  # slots its sort_device sorted (program counter)
    trace: "trace.Trace | None"  # its traced window, one entry a device op


@dataclasses.dataclass
class MeshContext(harness.Context):
    """What a metric reader reads in a multi-rank cell.  ``calls`` count
    the records of every rank; ``peak_bytes`` and ``base_bytes`` are the
    rank's whose own peak (peak less base) is largest, ``trace`` rank
    0's."""

    world: int = 1
    ranks: list = dataclasses.field(default_factory=list)
    link: "str | None" = None  # nvlink or pcie, as nvidia-smi shows the cards joined


@dataclasses.dataclass
class Rank:
    rank: int
    world: int
    dev: torch.device
    host: object  # a gloo group: the harness's barriers and gathers
    cfg: dict
    model: object
    fns: dict  # records a rank -> the program's sort over the mesh
    vals: dict  # records a rank -> this rank's payloads

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


@dataclasses.dataclass
class Window:
    calls: list
    kept: dict  # call index -> this rank's answer (the seed's on the host)
    t0: float
    window_s: float  # less the pause for the seed's answer
    trace: "trace.Trace | None"
    peak_bytes: int
    base_bytes: int
    setup_peak_bytes: int
    n_valid: int
    lost: int
    sort_records: int


# ---------------------------------------------------------------- parent


def launch(cell: manifest.Cell, spec: dict, *, device: str,
           timeout_s: float = RANK_TIMEOUT_S) -> list[str]:
    """Start ``cell.chips`` ranks running :func:`rank_main` with ``spec``
    and return each rank's standard output (``RuntimeError`` with the
    failing rank's output if one fails or the timeout passes)."""
    from repro_torch.launch import mesh

    root = manifest.ROOT
    with tempfile.TemporaryDirectory(prefix="perfbench-mesh-") as tmp:
        spec = {**spec, "cell": dataclasses.asdict(cell), "device": device,
                "init_method": f"file://{tmp}/store"}
        env = {SPEC_ENV: json.dumps(spec)}
        # each rank stands for a node: its share of the host's cores
        env["OMP_NUM_THREADS"] = os.environ.get(
            "OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // cell.chips)))
        if device == "cuda":  # one host: NCCL's bootstrap on the loopback
            env["NCCL_SOCKET_IFNAME"] = os.environ.get("NCCL_SOCKET_IFNAME", "lo")
            env["NCCL_IB_DISABLE"] = os.environ.get("NCCL_IB_DISABLE", "1")
            # the caching allocator's setting that the deployment states
            if "cuda_alloc_conf" in cell.config:
                env["PYTORCH_CUDA_ALLOC_CONF"] = cell.config["cuda_alloc_conf"]
        code = (f"import os, sys, time; os.environ[{STARTED_ENV!r}] = str(time.perf_counter()); "
                f"sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]; "
                "from perfbench import mesh_harness; mesh_harness.rank_main()")
        return mesh.spawn(code, cell.chips, env=env, timeout_s=timeout_s)


def relay(outs: list[str]) -> "dict | None":
    """Every rank's log to standard error; rank 0's result line, parsed."""
    result = None
    for r, out in enumerate(outs):
        lines = out.splitlines()
        if r == 0 and lines and lines[-1].startswith("{"):
            result = json.loads(lines.pop())
        for line in lines:
            harness.log(f"rank {r}: {line}")
    return result


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, *,
        device: str, t_start: float, timeout_s: float = RANK_TIMEOUT_S) -> "dict | None":
    """One run of ``cell``: rank 0's result line, or None (the failure
    on standard error)."""
    spec = {"mode": "run", "seed": seed, "seconds": seconds, "traced": traced,
            "t_start": t_start}
    try:
        outs = launch(cell, spec, device=device, timeout_s=timeout_s)
    except RuntimeError as e:
        harness.log(f"error: {e}")
        return None
    return relay(outs)


def control(cell: manifest.Cell, seeds: list, paths: list, seconds: float, *,
            device: str, timeout_s: "float | None" = None) -> list[dict]:
    """``control.py``'s multi-rank runs (:func:`control_rank`): rank 0's
    line for each seed and path, in order; the ranks' logs go to
    standard error."""
    spec = {"mode": "control", "seeds": seeds, "paths": paths, "seconds": seconds,
            "t_start": time.perf_counter()}
    if timeout_s is None:
        timeout_s = RANK_TIMEOUT_S + len(seeds) * len(paths) * (seconds + 40.0)
    outs = launch(cell, spec, device=device, timeout_s=timeout_s)
    lines = []
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if r == 0 and line.startswith("{"):
                lines.append(json.loads(line))
            else:
                harness.log(f"rank {r}: {line}")
    return lines


def main(cell: manifest.Cell, seed: int, seconds: float, traced: bool, *,
         t_start: float) -> int:
    """``run.py``'s multi-rank path; the parent touches no card."""
    from repro_torch.kernels import build

    build.library()
    info = build.build_info
    harness.log(f"setup: kernel library {info.get('path')} compiled={info.get('compiled')} "
                f"in {info.get('seconds', 0):.3f} s; ranks start "
                f"{time.perf_counter() - t_start:.3f} s since the start")
    result = run(cell, seed, seconds, traced, device="cuda", t_start=t_start)
    if result is None:
        return 4
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"error: loaded after the window: {bad}")
        return 3
    # a checkout's first run builds the kernel library: its seconds are
    # in setup_s, and here apart (0 where it was loaded from cache)
    result["device"]["build_s"] = info["seconds"] if info.get("compiled") else 0.0
    for k, v in result["checks"].items():
        harness.log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


# ----------------------------------------------------------------- ranks


def rank_main() -> None:
    """A rank's process: the spec from the parent, then ``exit_rank``."""
    from repro_torch.launch import mesh

    spec = json.loads(os.environ[SPEC_ENV])
    log(f"setup: rank {os.environ['RANK']} started "
        f"{float(os.environ[STARTED_ENV]) - spec['t_start']:.3f} s since the start")
    status = 0
    try:
        (run_rank if spec["mode"] == "run" else control_rank)(spec)
    except Exception:  # the boundary of the rank's process: report, exit non-zero
        traceback.print_exc()
        status = 1
    mesh.exit_rank(status)


def _cell(spec: dict) -> manifest.Cell:
    return manifest.Cell(**spec["cell"])


def rank_pool(cfg: dict, sched: traffic.Schedule, rank: int, world: int, dev) -> torch.Tensor:
    """This rank's input: the keys of every record of its own contiguous
    share of the file, in an order drawn from the seed.  The mix has to
    sort the whole share a call (``sizes`` the share, ``pool_factor``
    1)."""
    share = cfg["file_records"] // world
    if sched.sizes != [share] or sched.pool_records != share:
        raise ValueError(f"the mix has to sort a rank's whole share, {share} records, a call")
    seed = int(np.random.SeedSequence([sched.device_seed, rank]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed >> 1)
    order = torch.randperm(share, generator=gen, device=dev) + rank * share
    keys = torch.empty((share, cfg["key_bytes"]), dtype=torch.uint8, device=dev)
    for s in range(0, share, gensort_keys.CHUNK):
        keys[s : s + gensort_keys.CHUNK] = gensort_keys.keys_at(
            order[s : s + gensort_keys.CHUNK], cfg, gen)
    return keys


def checked_call(traffic_mix: dict, sched: traffic.Schedule) -> int:
    """The call whose answer the check keeps besides the last: drawn from
    the seed among the mix's first ``checked_within`` calls."""
    return sched.device_seed % int(traffic_mix["checked_within"])


def program_call():
    """The timed path of a rank: ``call(fn, keys, val) -> (hi_s, lo_s,
    val_s, n_valid, lost)``."""
    from repro_torch.kernels import ops

    def call(fn, keys, val):
        with record_function("perfbench.encode_keys"):
            hi, lo = ops.encode_keys(keys)
        with record_function("perfbench.sort_fn"):
            return fn(hi, lo, val)

    return call


def start(spec: dict, cell: manifest.Cell, sched: traffic.Schedule):
    """Set-up of a rank: the process groups, its pool, the model, one
    sort a size, each called once.  Returns ``(Rank, pool)``."""
    from repro_torch.core import distributed
    from repro_torch.launch import mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cfg = cell.config
    if cfg["ranks"] != world:
        raise ValueError(f"the configuration states {cfg['ranks']} ranks, {world} started")

    def since() -> str:
        return f"{time.perf_counter() - spec['t_start']:.3f} s since the start"

    log(f"setup: rank {rank} imported the program, {since()}")
    mesh.initialize_multiprocess(spec["init_method"], world, rank, device=spec["device"],
                                 timeout_s=GROUP_TIMEOUT_S)
    m = mesh.make_data_mesh(world, device=spec["device"])
    host = dist.new_group(backend="gloo")
    dev = m.device
    log(f"setup: rank {rank} of {world} on {dev}, backend {m.backend}, {since()}")

    t = time.perf_counter()
    pool = rank_pool(cfg, sched, rank, world, dev)
    share = cfg["file_records"] // world
    log(f"setup: input of file records [{rank * share}, {(rank + 1) * share}) "
        f"in {time.perf_counter() - t:.3f} s, {since()}")
    t = time.perf_counter()
    model, digest = harness.train_model(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    digests = [None] * world
    dist.all_gather_object(digests, digest, group=host)
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks trained different models: {digests}")
    log(f"setup: model ({cfg['n_leaf']} leaves, leaf table sha256 {digest}, "
        f"the same on every rank) trained in {time.perf_counter() - t:.3f} s, {since()}")

    fns, vals = {}, {}
    for n in sorted(set(sched.sizes)):
        fns[n] = distributed.make_sort_fn(
            m, ("data",), model, n, capacity_factor=cfg["capacity_factor"],
            pre_shuffle=cfg["pre_shuffle"])
        vals[n] = torch.arange(rank * n, (rank + 1) * n, dtype=torch.int32, device=dev)
    st = Rank(rank, world, dev, host, cfg, model, fns, vals)
    t = time.perf_counter()
    call = program_call()
    for n in sorted(fns):
        out = call(fns[n], pool[:n], vals[n])
        st.sync()
        del out
    log(f"setup: {len(fns)} size(s) warmed in {time.perf_counter() - t:.3f} s, {since()}")
    return st, pool


def to_host(out) -> tuple:
    """The valid prefix of a rank's answer, and its counts, on the host:
    all that the check reads (:func:`mesh_reference.check` reads the
    first ``n_valid`` rows, or the whole answer where it reports more)."""
    hi, lo, val, n_valid, lost = out
    k = min(max(int(n_valid.reshape(-1)[0]), 0), hi.shape[0], lo.shape[0], val.shape[0])
    return tuple(x[:k].cpu() for x in (hi, lo, val)) + (n_valid.cpu(), lost.cpu())


def compact(tr: trace.Trace) -> trace.Trace:
    """``tr`` with one device entry an op name (its seconds summed), so
    that it is small enough to gather."""
    by: dict = {}
    for name, s, e in tr.device:
        by[name] = by.get(name, 0) + (e - s)
    return trace.Trace(tr.window_s, tr.busy_s, [(k, 0, v) for k, v in by.items()],
                       tr.idle_by_host)


def window(st: Rank, pool, sched: traffic.Schedule, seconds: float, call,
           traced: bool, keep: int) -> Window:
    """The measured window of one rank, every rank at once; the answer
    of call ``keep`` goes to the host with the clock stopped."""
    from repro_torch.core import learned_sort
    from repro_torch.kernels import ops

    cuda = st.dev.type == "cuda"
    ops.reset_launches()
    setup_peak = torch.cuda.max_memory_allocated(st.dev) if cuda else 0
    base = torch.cuda.memory_allocated(st.dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(st.dev)
    prof = trace.start(cuda) if traced else None
    calls, kept, n_valid, lost = [], {}, [], []
    stop = torch.zeros(1, dtype=torch.int32)
    out = None
    paused = 0.0
    dist.barrier(group=st.host)
    with record_function(trace.WINDOW):
        t0 = time.perf_counter()
        i = 0
        while not stop[0]:
            n, off = sched.call(i)
            out = None
            with record_function("perfbench.call"):
                c0 = time.perf_counter()
                out = call(st.fns[n], pool[off : off + n], st.vals[n])
                st.sync()
                # the barrier of every rank, which carries rank 0's word on
                # the window; it is also the barrier before the next call
                stop[0] = int(st.rank == 0 and time.perf_counter() - t0 - paused >= seconds)
                dist.all_reduce(stop, op=dist.ReduceOp.MAX, group=st.host)
                c1 = time.perf_counter()
            calls.append(harness.Call(n * st.world, c1 - c0, False))
            n_valid.append(out[3].reshape(-1)[:1])
            lost.append(out[4].reshape(-1)[:1])
            if i == keep:
                with record_function(trace.PAUSE):
                    p0 = time.perf_counter()
                    kept[i] = to_host(out)
                    dist.barrier(group=st.host)
                    paused += time.perf_counter() - p0
            i += 1
        window_s = c1 - t0 - paused
    tr = compact(trace.stop(prof)) if traced else None
    log(f"window: {paused:.3f} s paused to copy call {keep}'s answer to the host")
    peak = torch.cuda.max_memory_allocated(st.dev) if cuda else 0
    kept.setdefault(len(calls) - 1, out)
    return Window(
        calls=calls, kept=kept, t0=t0, window_s=window_s, trace=tr, peak_bytes=peak,
        base_bytes=base, setup_peak_bytes=setup_peak,
        n_valid=int(torch.cat(n_valid).to(torch.int64).sum()),
        lost=int(torch.cat(lost).to(torch.int64).sum()),
        sort_records=learned_sort.sort_device.records,
    )


def check(st: Rank, pool, sched: traffic.Schedule, kept: dict) -> tuple[dict, int]:
    """The reference's counts over every kept answer, and how many of
    those calls had any count over 0; the same on every rank."""
    totals = dict.fromkeys(mesh_reference.LIMITS, 0)
    failed = 0
    for i in sorted(kept):
        n, off = sched.call(i)
        bad = mesh_reference.check(pool[off : off + n], *(x.to(st.dev) for x in kept[i]),
                                   rank=st.rank, world=st.world)
        log(f"check: call {i} ({n} records a rank at {off}): {bad}")
        failed += any(bad.values())
        for k, v in bad.items():
            totals[k] += v
    return totals, failed


def topology(world: int) -> tuple[str, "str | None"]:
    """How the first ``world`` cards are joined, and their link:
    :func:`parse_topology` of ``nvidia-smi topo -m``, or where that
    matrix cannot be read, :func:`parse_nvlink_status` of ``nvidia-smi
    nvlink --status``."""
    for args, parse in ((["topo", "-m"], parse_topology),
                        (["nvlink", "--status"], parse_nvlink_status)):
        try:
            out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                                 timeout=20)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"not read ({e})", None
        text, link = parse(out.stdout, world)
        if link is not None:
            return f"nvidia-smi {' '.join(args)}: {text}", link
    return "not read", None


def parse_nvlink_status(text: str, world: int) -> tuple[str, "str | None"]:
    """The active NVLinks of each of the first ``world`` cards in
    ``nvidia-smi nvlink --status``: ``nvlink`` where every one has some,
    ``("not read", None)`` where one has none or is missing."""
    links: dict = {}
    card = None
    for line in text.splitlines():
        m = re.match(r"\s*GPU (\d+):", line)
        if m:
            card = int(m.group(1))
            links[card] = []
        elif card is not None and (m := re.match(r"\s*Link \d+: ([\d.]+ GB/s)", line)):
            links[card].append(m.group(1))
    if any(not links.get(i) for i in range(world)):
        return "not read", None
    return "; ".join(f"GPU{i}: {len(links[i])} links at {' '.join(sorted(set(links[i])))}"
                     for i in range(world)), "nvlink"


def parse_topology(text: str, world: int) -> tuple[str, "str | None"]:
    """The rows of the first ``world`` cards in ``nvidia-smi topo -m``'s
    matrix, and their link: ``nvlink`` where every pair is joined by NV#,
    else ``pcie``; ``("not read", None)`` where a row is missing."""
    rows = {}
    for line in re.sub(r"\x1b\[[0-9;]*m", "", text).splitlines():
        f = line.split()
        if f and re.fullmatch(r"GPU\d+", f[0]) and len(f) > world:
            rows[f[0]] = f[1 : 1 + world]
    cards = [f"GPU{i}" for i in range(world)]
    if any(c not in rows for c in cards):
        return "not read", None
    links = [rows[c][j] for i, c in enumerate(cards) for j in range(world) if j != i]
    link = "nvlink" if all(x.startswith("NV") for x in links) else "pcie"
    return "; ".join(f"{c}: {' '.join(rows[c])}" for c in cards), link


def nccl_seconds(tr: trace.Trace) -> float:
    """Device seconds of NCCL's kernels (``ncclDevKernel_*``,
    ``ncclKernel_*``) in ``tr``."""
    return tr.seconds(lambda name: trace.kernel_id(name).startswith("nccl"))


def _mean_top(dicts: list, k: int = 10) -> list:
    by: dict = {}
    for d in dicts:
        for name, v in d.items():
            by[name] = by.get(name, 0.0) + v / len(dicts)
    return [[name, v] for name, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def result_line(cell: manifest.Cell, w: Window, ranks: list, setup_s: float,
                totals: dict, failed: int, traced: bool, cuda: bool) -> dict:
    """Rank 0's result line from every rank's :class:`RankRun`."""
    world = len(ranks)
    top = max(ranks, key=lambda r: r.peak_bytes - r.base_bytes)
    topo, link = topology(world) if cuda else ("cpu", None)
    if cuda and link is None:
        # the higher peak: a roofline share can then only read low
        link = "nvlink"
        topo += "; the link not read, NVLink's peak taken"
    ctx = MeshContext(
        config=cell.config, device_name=ranks[0].device_name, calls=w.calls,
        window_s=w.window_s, setup_s=setup_s, peak_bytes=top.peak_bytes,
        base_bytes=top.base_bytes, trace=ranks[0].trace,
        port_kernels=trace.port_kernel_names(manifest.ROOT / "src" / "repro_torch" / "csrc"),
        world=world, ranks=ranks, link=link,
    )
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": ctx.device_name,
        "count": world,
        "memory_peak_bytes": max(max(r.peak_bytes, r.setup_peak_bytes) for r in ranks),
        "memory_peak_bytes_by_rank": [max(r.peak_bytes, r.setup_peak_bytes) for r in ranks],
        "topology": topo,
        "link": link,
    }
    if traced:
        dev_info.update(busy_s=sum(r.trace.busy_s for r in ranks) / world,
                        window_s=sum(r.trace.window_s for r in ranks) / world)
    if cuda:
        dev_info["name_power_limit"] = harness._power_limit()
    result = {
        "correct": not any(v > mesh_reference.LIMITS[k] for k, v in totals.items()),
        "attempted": len(w.calls),
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if traced:
        result["breakdown"] = {
            "device_ops": _mean_top([{n: e / 1e9 for n, _, e in r.trace.device} for r in ranks]),
            "idle_gaps": _mean_top([r.trace.idle_by_host for r in ranks]),
        }
    result["checks"] = {k: {"value": v, "limit": mesh_reference.LIMITS[k]}
                        for k, v in totals.items()}
    return result


def run_rank(spec: dict) -> None:
    cell = _cell(spec)
    sched = traffic.Schedule(cell.traffic, spec["seed"])
    st, pool = start(spec, cell, sched)
    w = window(st, pool, sched, spec["seconds"], program_call(), spec["traced"],
               checked_call(cell.traffic, sched))
    setup_s = w.t0 - spec["t_start"]
    per_call = [c.seconds for c in w.calls]
    log(f"window: {len(w.calls)} calls, {sum(c.n for c in w.calls)} records of all ranks "
        f"in {w.window_s:.6f} s; call ms p50 {stats.percentile(per_call, 50) * 1e3:.4f} "
        f"p95 {stats.percentile(per_call, 95) * 1e3:.4f} max {max(per_call) * 1e3:.4f}; "
        f"each: {' '.join(f'{c * 1e3:.1f}' for c in per_call)}")
    log(f"window: peak {w.peak_bytes} B allocated, {w.base_bytes} B of it at the start; "
        f"set-up peak {w.setup_peak_bytes} B; records in answers {w.n_valid}, "
        f"sort_device slots {w.sort_records}, lost {w.lost}; checked calls {sorted(w.kept)}")
    if w.trace is not None:
        log(f"trace: device busy {w.trace.busy_s:.6f} s of {w.trace.window_s:.6f} s")
    st.fns.clear()
    st.model = None
    totals, failed = check(st, pool, sched, w.kept)
    mine = RankRun(
        device_name=torch.cuda.get_device_name(st.dev) if st.dev.type == "cuda" else "cpu",
        peak_bytes=w.peak_bytes, base_bytes=w.base_bytes, setup_peak_bytes=w.setup_peak_bytes,
        n_valid=w.n_valid, sort_records=w.sort_records, trace=w.trace,
    )
    ranks = [None] * st.world if st.rank == 0 else None
    dist.gather_object(mine, ranks, dst=0, group=st.host)
    bad = harness.forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded after the window: {bad}")
    if st.rank == 0:
        result = result_line(cell, w, ranks, setup_s, totals, failed, spec["traced"],
                             st.dev.type == "cuda")
        print(json.dumps(result), flush=True)


def control_rank(spec: dict) -> None:
    """``control.py``'s multi-rank path: set-up once, then for each seed
    a pool and, for each path, a short window with that path in the
    program's place and its check; rank 0 prints one line a run."""
    from perfbench import controls

    cell = _cell(spec)
    st = pool = None
    for seed in spec["seeds"]:
        sched = traffic.Schedule(cell.traffic, seed)
        if st is None:
            st, pool = start(spec, cell, sched)
        else:
            pool = None
            pool = rank_pool(st.cfg, sched, st.rank, st.world, st.dev)
        for name in spec["paths"]:
            sched = traffic.Schedule(cell.traffic, seed)
            call = controls.mesh_call_for(name, program_call(), st)
            w = window(st, pool, sched, spec["seconds"], call, False, 0)
            totals, failed = check(st, pool, sched, w.kept)
            attempted = len(w.calls)
            del w
            if st.rank == 0:
                print(json.dumps({"workload": cell.name, "seed": seed, "path": name,
                                  "correct": not any(totals.values()),
                                  "attempted": attempted,
                                  "failed": failed, "checks": totals}), flush=True)
