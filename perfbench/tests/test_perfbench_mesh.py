"""The multi-rank runner and the distributed reference, with 4 gloo ranks
on the CPU at a small size (``repro_torch.launch.mesh.spawn``, a hard
timeout): the program reads correct; every control and planted fault
reads not correct and raises its own count; a whole run prints a
result line; the new cell's metrics are its own.  The harness's look
for the cards is skipped (``device="cpu"``) and the rest of a run is
driven as it is."""

import copy
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import record_function

from perfbench import controls, harness, manifest, mesh_harness, roofline, trace, traffic

CELL = "gensort-skew-4gpu.mesh-arrays"
OLD_CELLS = ("gensort-uniform.hbm-arrays", "gensort-skew.hbm-arrays")
NEW_METRICS = ["exchange_ms", "exchange_roofline", "partition_imbalance_pct", "pad_slots_pct",
               "mesh_idle_pct"]
SEED = 2**35 + 11
TIMEOUT_S = 240.0
# the count each path in the program's place must raise
RAISES = {
    "hi32": "order_bad", "f64": "order_bad",
    "drop": "perm_bad", "dup": "perm_bad", "swap": "order_bad", "reverse": "order_bad",
    "altered": "words_bad", "lost": "lost_bad",
    "unchanged": "order_bad", "half": "perm_bad", "noexchange": "order_bad",
}


FILE = 1 << 14


def tiny_mesh_cell() -> manifest.Cell:
    """The 4-card cell at a size 4 CPU ranks hold: a 2**14-record file
    (its second half one spike, on ranks 2 and 3), 256 leaves, a rank's
    whole quarter (4 Ki records) a call, the seed's answer kept from one
    of the first 2 calls."""
    cell = copy.deepcopy(manifest.cell(manifest.load(), CELL))
    cell.config.update(file_records=FILE, records_per_rank_max=FILE // 4,
                       records_per_call_max=FILE, n_leaf=256)
    cell.traffic.update(sizes=[FILE // 4], checked_within=2)
    return cell


@pytest.fixture(scope="module")
def control_lines():
    paths = ["program", *controls.MESH_CONTROLS, *controls.MESH_FAULTS]
    lines = mesh_harness.control(tiny_mesh_cell(), [SEED], paths, 0.05, device="cpu",
                                 timeout_s=TIMEOUT_S)
    return {line["path"]: line for line in lines}


@pytest.fixture(scope="module")
def runs():
    """An untraced and a traced whole run of the tiny cell."""
    cell = tiny_mesh_cell()
    return {traced: mesh_harness.run(cell, SEED + traced, 0.3, traced, device="cpu",
                                     t_start=time.perf_counter(), timeout_s=TIMEOUT_S)
            for traced in (False, True)}


def test_every_path_ran(control_lines):
    assert set(control_lines) == {"program", *RAISES}
    assert set(RAISES) == set(controls.MESH_CONTROLS + controls.MESH_FAULTS)


def test_the_program_is_correct(control_lines):
    line = control_lines["program"]
    assert line["correct"] and line["failed"] == 0
    assert line["checks"] == dict.fromkeys(["lost_bad", "order_bad", "perm_bad", "words_bad"], 0)


@pytest.mark.parametrize("path", sorted(RAISES))
def test_each_control_and_fault_raises_its_own_count(control_lines, path):
    line = control_lines[path]
    assert not line["correct"] and line["failed"] >= 1
    assert line["checks"][RAISES[path]] > 0


@pytest.mark.parametrize("traced", [False, True])
def test_a_whole_run_prints_a_correct_line(runs, traced):
    r = runs[traced]
    assert r is not None
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert {k: v["value"] for k, v in r["checks"].items()} == dict.fromkeys(
        ["lost_bad", "order_bad", "perm_bad", "words_bad"], 0)
    assert r["device"]["count"] == 4 and len(r["device"]["memory_peak_bytes_by_rank"]) == 4
    names = set(r["metrics"])
    if traced:
        # no device here: the trace's readers find nothing, the counters do
        assert names == {"partition_imbalance_pct", "pad_slots_pct"}
        assert 0 < r["metrics"]["pad_slots_pct"]["value"] < 100
        assert "busy_s" in r["device"] and "breakdown" in r
    else:
        # peak_GiB reads no card's peak on the CPU
        assert names == {"sort_Mrec_s", "setup_s"}
        assert r["metrics"]["setup_s"]["value"] > 0
        # every call sorts the whole file: 4 quarters of FILE // 4 records
        assert r["metrics"]["sort_Mrec_s"]["value"] > 0


def test_a_failing_rank_fails_the_run(capfd):
    cell = tiny_mesh_cell()
    cell.config["ranks"] = 8  # the configuration and the 4 ranks disagree
    r = mesh_harness.run(cell, SEED, 0.1, False, device="cpu", t_start=time.perf_counter(),
                         timeout_s=TIMEOUT_S)
    assert r is None
    assert "8 ranks, 4 started" in capfd.readouterr().err


def test_each_rank_holds_every_record_of_its_own_quarter_of_the_file():
    cell = tiny_mesh_cell()
    sched = traffic.Schedule(cell.traffic, SEED)
    table = torch.tensor([list(bytes.fromhex(h)) for h in cell.config["skew"]["table_hex"]],
                         dtype=torch.uint8)
    pools = [mesh_harness.rank_pool(cell.config, sched, r, 4, "cpu") for r in range(4)]
    assert all(p.shape == (FILE // 4, 10) for p in pools)
    for r, p in enumerate(pools):
        # each record of [r * F/4, (r + 1) * F/4) once: its skew row, by
        # floor(log2(index)), as often as the quarter's indices give it
        idx = torch.arange(r * FILE // 4, (r + 1) * FILE // 4).clamp(min=1)
        want = torch.bincount(torch.frexp(idx.double())[1].long() - 1, minlength=128)
        got = torch.zeros(128, dtype=torch.int64)
        for j in range(128):
            got[j] = (p[:, :6] == table[j]).all(1).sum()
        assert torch.equal(got, want)
    # the file's second half is one spike, table row 13: on ranks 2 and 3 alone
    assert all((p[:, :6] == table[13]).all(1).all() == (r >= 2) for r, p in enumerate(pools))
    again = mesh_harness.rank_pool(cell.config, sched, 1, 4, "cpu")
    other = mesh_harness.rank_pool(cell.config, traffic.Schedule(cell.traffic, SEED + 1), 1, 4,
                                   "cpu")
    assert torch.equal(again, pools[1]) and not torch.equal(other, pools[1])


def test_a_mix_that_is_not_the_whole_quarter_is_refused():
    cell = tiny_mesh_cell()
    cell.traffic.update(sizes=[FILE // 8])
    with pytest.raises(ValueError, match="whole share"):
        mesh_harness.rank_pool(cell.config, traffic.Schedule(cell.traffic, SEED), 0, 4, "cpu")


def test_the_seed_draws_the_kept_call_and_its_prefix_goes_to_the_host():
    cell = tiny_mesh_cell()
    cell.traffic.update(checked_within=16)
    drawn = {mesh_harness.checked_call(cell.traffic, traffic.Schedule(cell.traffic, SEED + k))
             for k in range(64)}
    assert drawn <= set(range(16)) and len(drawn) > 8
    out = (torch.arange(8), torch.arange(8) + 1, torch.arange(8, dtype=torch.int32),
           torch.tensor([5], dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    hi, lo, val, n_valid, lost = mesh_harness.to_host(out)
    assert hi.tolist() == [0, 1, 2, 3, 4] and lo.shape == val.shape == (5,)
    assert int(n_valid[0]) == 5 and int(lost[0]) == 0
    # a count past the answer keeps the whole answer and the count itself
    over = mesh_harness.to_host(out[:3] + (torch.tensor([9], dtype=torch.int32), out[4]))
    assert over[0].shape == (8,) and int(over[3][0]) == 9


def test_a_pause_is_cut_out_of_the_traced_window():
    assert trace._minus(0, 10, [[2, 3], [5, 12]]) == [(0, 2), (3, 5)]
    assert trace._minus(0, 10, []) == [(0, 10)]
    prof = trace.start(False)
    with record_function(trace.WINDOW):
        time.sleep(0.05)
        with record_function(trace.PAUSE):
            time.sleep(0.2)
        time.sleep(0.05)
    tr = trace.stop(prof)
    assert 0.09 < tr.window_s < 0.2


def test_the_new_cell_gets_its_own_metrics_and_the_old_ones_theirs():
    bench = manifest.load()
    e2e = ["sort_Mrec_s", "call_ms_p95", "peak_GiB", "setup_s"]
    cell = manifest.cell(bench, CELL)
    assert [m["name"] for m in cell.end_to_end] == ["sort_Mrec_s", "peak_GiB", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == NEW_METRICS
    assert {m["moves"] for m in cell.per_layer} == {"sort_Mrec_s"}
    assert cell.chips == 4
    old = {
        "gensort-uniform.hbm-arrays": ["fallback_pct", "torch_ops_ms", "rmi_roofline",
                                       "sort_rows_roofline", "device_idle_pct",
                                       "fallback_records_pct"],
        "gensort-skew.hbm-arrays": ["fallback_pct", "torch_ops_ms", "rmi_roofline",
                                    "device_idle_pct", "fallback_records_pct"],
    }
    for name in OLD_CELLS:
        c = manifest.cell(bench, name)
        assert [m["name"] for m in c.end_to_end] == e2e
        assert [m["name"] for m in c.per_layer] == old[name]
        assert c.chips == 1


def test_the_configuration_states_its_deployment():
    cfg = manifest.cell(manifest.load(), CELL).config
    skew = manifest.cell(manifest.load(), "gensort-skew.hbm-arrays").config
    for key in ("file_records", "file_seed", "key_bytes", "ascii_lo", "ascii_hi", "sample",
                "n_leaf", "skew"):
        assert cfg[key] == skew[key]
    assert cfg["ranks"] == 4 and cfg["input_split"] == "contiguous quarters"
    assert cfg["records_per_rank_max"] * cfg["ranks"] == cfg["records_per_call_max"]
    assert cfg["records_per_call_max"] == cfg["file_records"]
    assert cfg["guarantees"]["stable"].startswith("not given")
    mix = manifest.cell(manifest.load(), CELL).traffic
    # every call sorts the whole file: each rank its whole quarter
    assert mix["sizes"] == [cfg["file_records"] // cfg["ranks"]] and mix["pool_factor"] == 1


H100 = "NVIDIA H100 80GB HBM3"


def _rank(n_valid, sort_records, nccl_ms=0.0, busy_s=0.9, window_s=1.0):
    tr = trace.Trace(window_s=window_s, busy_s=busy_s,
                     device=[("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 0,
                              int(nccl_ms * 1e6)),
                             ("void at::native::elementwise_kernel<128, 4>(int)", 0, 10**8)],
                     idle_by_host={})
    return mesh_harness.RankRun(device_name=H100, peak_bytes=0, base_bytes=0,
                                setup_peak_bytes=0, n_valid=n_valid,
                                sort_records=sort_records, trace=tr)


def _ctx(ranks, n_rank=1 << 27, calls=10, link="nvlink"):
    return mesh_harness.MeshContext(
        config={}, device_name=H100,
        calls=[harness.Call(n_rank * len(ranks), 0.1, False) for _ in range(calls)],
        window_s=1.0, setup_s=30.0, peak_bytes=0, base_bytes=0, trace=ranks[0].trace,
        port_kernels=set(), world=len(ranks), ranks=ranks, link=link,
    )


def test_the_mesh_readers():
    ranks = [_rank(100, 200, 300.0), _rank(110, 200, 100.0), _rank(90, 200, 200.0),
             _rank(100, 200, 200.0, busy_s=0.5)]
    ctx = _ctx(ranks)
    read = {m: manifest.reader(m)(ctx) for m in NEW_METRICS}
    assert read["exchange_ms"] == pytest.approx(20.0)  # 200 ms a rank over 10 calls
    least = 10 * (1 << 27) * 0.75 * 12 / 450e9
    assert read["exchange_roofline"] == pytest.approx(
        100 * least * (1 / 0.3 + 1 / 0.1 + 2 / 0.2) / 4)
    assert read["partition_imbalance_pct"] == pytest.approx(10.0)
    assert read["pad_slots_pct"] == pytest.approx(50.0)
    assert read["mesh_idle_pct"] == pytest.approx((10 + 10 + 10 + 50) / 4)
    assert roofline.exchange_bytes(1 << 27, 4) == (1 << 27) * 0.75 * 12


def test_the_mesh_readers_find_nothing_without_a_trace_or_a_link():
    ranks = [_rank(100, 200, 300.0) for _ in range(4)]
    assert manifest.reader("exchange_roofline")(_ctx(ranks, link=None)) is None
    assert manifest.reader("exchange_roofline")(_ctx(ranks, link="pcie")) > 0
    for r in ranks:
        r.trace = None
    for m in ("exchange_ms", "exchange_roofline", "mesh_idle_pct"):
        assert manifest.reader(m)(_ctx(ranks)) is None
    for r in ranks:
        r.sort_records = r.n_valid = 0
    for m in ("partition_imbalance_pct", "pad_slots_pct"):
        assert manifest.reader(m)(_ctx(ranks)) is None


def test_the_topology_matrix_is_read():
    rows = ["\x1b[4m\tGPU0\tGPU1\tGPU2\tGPU3\tCPU Affinity\x1b[0m",
            "GPU0\t X \tNV18\tNV18\tNV18\t0-31", "GPU1\tNV18\t X \tNV18\tNV18\t0-31",
            "GPU2\tNV18\tNV18\t X \tNV18\t0-31", "GPU3\tNV18\tNV18\tNV18\t X \t0-31"]
    text, link = mesh_harness.parse_topology("\n".join(rows), 4)
    assert link == "nvlink" and text.startswith("GPU0: X NV18 NV18 NV18;")
    assert mesh_harness.parse_topology("\n".join(rows).replace("NV18", "SYS", 1), 4)[1] == "pcie"
    assert mesh_harness.parse_topology("\n".join(rows[:3]), 4) == ("not read", None)


def test_a_run_with_fewer_cards_exits_non_zero_with_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload", CELL,
         "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 4 CUDA card(s)" in out.stderr


def test_a_result_line_from_gathered_ranks():
    # where nvidia-smi cannot say how the cards are joined, the link takes
    # NVLink's peak, the higher, so the exchange's share can only read low
    cell = manifest.cell(manifest.load(), CELL)
    ranks = [_rank(100, 200, 300.0), _rank(110, 200, 100.0), _rank(90, 200, 200.0),
             _rank(100, 200, 200.0)]
    ctx = _ctx(ranks)
    w = mesh_harness.Window(calls=ctx.calls, kept={}, t0=0.0, window_s=1.0, trace=None,
                            peak_bytes=0, base_bytes=0, setup_peak_bytes=0, n_valid=0, lost=0,
                            sort_records=0)
    totals = dict.fromkeys(["lost_bad", "order_bad", "perm_bad", "words_bad"], 0)
    r = mesh_harness.result_line(cell, w, ranks, 30.0, totals, 0, True, True)
    assert r["correct"] and list(r)[-1] == "checks"
    assert r["device"]["count"] == 4 and r["device"]["link"] in ("nvlink", "pcie")
    assert set(r["metrics"]) == set(NEW_METRICS)
    assert 0 < r["metrics"]["exchange_roofline"]["value"] < 100
    assert r["device"]["busy_s"] == pytest.approx(0.9)
    # the mean over ranks: 300, 100, 200 and 200 ms of NCCL a window
    assert r["breakdown"]["device_ops"][0] == [
        "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", pytest.approx(0.2)]
