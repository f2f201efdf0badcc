"""The file-sort driver, on the CPU at 20,000 records: the program comes
out correct, each control and planted fault raises its own count, the
reference is the stable sort, the readers read ``SortStats``, and the
dispatch on the mix's driver leaves the other cells on
``harness.run_cell``.

``gensort-skew-1GB.file-sort`` is not in ``BENCHMARK.json``: its rate
spreads too widely from run to run for any bound (PERF.md section 7).
The tests add it with the entries below, as a later change that adds
the cell would, to files that are all there already."""

import copy
import dataclasses
import hashlib
import json
import time

import numpy as np
import pytest
import torch

from perfbench import file_reference, gensort_file, gensort_keys, harness, manifest, trace

CELL = "gensort-skew-1GB.file-sort"
N = 20_000
SEED = 2**35 + 11
# the cell's entries in BENCHMARK.json, and the per-layer metrics it reports
CONFIG = {"name": "gensort-skew-1GB", "file": "perfbench/configs/gensort-skew-1GB.json",
          "reduced": ["file_records"]}
WORKLOAD = {"name": CELL, "config": "gensort-skew-1GB", "traffic": "file-sort", "chips": 1}
READERS = {  # name: unit, better, source
    "partition_s": ("s", "lower", "program_span"),
    "sort_stage_s": ("s", "lower", "program_span"),
    "write_s": ("s", "lower", "program_span"),
    "batch_occupancy_pct": ("%", "higher", "program_counter"),
    "spill_disk_pct": ("%", "lower", "program_counter"),
}
# each accepted cell as it resolves: chips, config, mix and metric names
ACCEPTED = {
    "gensort-uniform.hbm-arrays": "bff7892292c32eaf5eeb38c24e0e7641be72c40f53610dd895d07e5498b520b9",
    "gensort-skew.hbm-arrays": "d4f2dc1705d0f460e48e07cdc4f97ea8e984ef9a40f48d65a843a9f7fd9bfb16",
    "gensort-skew-4gpu.mesh-arrays": "624de8a05f9f2072b6a83757731a0000b9fec01a39d0bba8b3f178ffc1f25b76",
}
# the count each control and fault is built to raise
RAISES = {"hi32": "order_bad", "prefix8": "order_bad", "drop": "size_bad", "dup": "perm_bad",
          "swap": "order_bad", "unstable": "ties_bad", "altered": "bytes_bad",
          "unchanged": "order_bad", "truncated": "size_bad"}


def with_file_cell(bench: dict) -> dict:
    """``bench`` with the file cell added: its configuration and cell,
    its readers, and the cell in ``device_idle_pct``'s list."""
    bench = copy.deepcopy(bench)
    bench["configs"].append(CONFIG)
    bench["workloads"].append(WORKLOAD)
    for m in bench["per_layer"]:
        if m["name"] == "device_idle_pct":
            m["workloads"].append(CELL)
    bench["per_layer"] += [
        {"name": r, "unit": unit, "better": better, "source": source,
         "layer": "pipeline stages", "moves": "sort_Mrec_s", "workloads": [CELL]}
        for r, (unit, better, source) in READERS.items()]
    return bench


def file_cell_entry() -> manifest.Cell:
    return manifest.cell(with_file_cell(manifest.load()), CELL)


@pytest.fixture
def file_cell(tmp_path):
    """``file_cell(ascii_hi=None)``: the cell at 20,000 records on the
    CPU, through the batched executor, its files under ``tmp_path``; a
    narrow ``ascii_hi`` makes whole 10-byte keys repeat."""

    def make(ascii_hi=None) -> manifest.Cell:
        cell = file_cell_entry()
        cell.config.update(file_records=N, records_per_call_max=N)
        if ascii_hi is not None:
            cell.config["ascii_hi"] = ascii_hi
        cell.config["sort_config"].update(executor="batched", memory_budget_bytes=1 << 20)
        cell.traffic.update(sizes=[N], work_dir=str(tmp_path / "work"))
        return cell

    return make


def _run(cell, sort=None, drv=None, seconds=0.2):
    drv = drv or manifest.driver("file_sort")
    return drv.run(cell, SEED, seconds, False, device="cpu", t_start=time.perf_counter(),
                   sort=sort)


@pytest.mark.parametrize("ascii_hi", [None, 33])
def test_the_program_is_correct(file_cell, ascii_hi, tmp_path):
    r = _run(file_cell(ascii_hi))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r["checks"]) == list(file_reference.LIMITS)
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"sort_Mrec_s", "setup_s"}  # no card: no peak
    assert not (tmp_path / "work").exists()


def test_a_traced_run_reads_the_stages(file_cell):
    drv = manifest.driver("file_sort")
    r = drv.run(file_cell(), SEED, 0.2, True, device="cpu", t_start=time.perf_counter())
    assert r["correct"]
    assert set(READERS) <= set(r["metrics"]) <= {*READERS, "device_idle_pct"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("path", list(RAISES))
def test_each_control_and_fault_raises_its_count(file_cell, path):
    drv = manifest.driver("file_sort")
    assert path in drv.PATHS
    r = _run(file_cell(33), drv.sort_for(path), drv)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"][RAISES[path]]["value"] > 0
    if path in ("unstable", "altered"):
        assert r["checks"]["order_bad"]["value"] == 0 and r["checks"]["perm_bad"]["value"] == 0


def test_the_file_is_gensort_ascii(file_cell, tmp_path):
    cell = file_cell()
    path = tmp_path / "in.bin"
    gensort_file.write(path, cell.config, SEED, torch.device("cpu"))
    rec = np.fromfile(path, dtype=np.uint8).reshape(N, 100)
    assert (rec[:, 10:12] == 32).all() and (rec[:, 44:46] == 32).all()
    assert (rec[:, 98] == 13).all() and (rec[:, 99] == 10).all()
    assert rec[:, :10].min() >= 32 and rec[:, :10].max() <= 126
    assert bytes(rec[255, 12:44]) == b"%032X" % 255
    filler = rec[:, 46:98].reshape(N, 13, 4)
    assert (filler == filler[:, :, :1]).all()
    nums = file_reference.record_numbers(torch.from_numpy(rec))
    assert torch.equal(nums, torch.arange(N))
    table = gensort_keys.skew_table(cell.config, "cpu").numpy()
    idx = np.maximum(np.arange(N), 1)
    assert (rec[:, :6] == table[np.floor(np.log2(idx)).astype(int) % 128]).all()
    again = tmp_path / "again.bin"
    gensort_file.write(again, cell.config, SEED, torch.device("cpu"))
    assert again.read_bytes() == path.read_bytes()


def test_the_reference_is_the_stable_sort(file_cell, tmp_path):
    path = tmp_path / "in.bin"
    gensort_file.write(path, file_cell(33).config, SEED, torch.device("cpu"))
    rec = np.fromfile(path, dtype=np.uint8).reshape(N, 100)
    want = b"".join(sorted((bytes(r) for r in rec), key=lambda r: r[:10]))
    ref = file_reference.Reference(path, 10, "cpu")
    assert ref.sorted.numpy().tobytes() == want
    out = tmp_path / "out.bin"
    out.write_bytes(want)
    assert set(ref.check(out).values()) == {0}


def test_a_mix_without_a_driver_runs_through_the_harness():
    bench = manifest.load()
    for name, digest in ACCEPTED.items():
        c = manifest.cell(bench, name)
        got = json.dumps([c.chips, c.config, c.traffic, [m["name"] for m in c.end_to_end],
                          [m["name"] for m in c.per_layer]], sort_keys=True)
        assert hashlib.sha256(got.encode()).hexdigest() == digest, name
        assert "driver" not in c.traffic and manifest.runner(c) is harness.run_cell


def test_a_driver_is_found_by_its_name_alone(tmp_path):
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "toy.py").write_text(
        "PATHS = ('nothing',)\n\n\ndef run(cell, seed, seconds, traced, *, device, t_start, sort=None):\n"
        "    return {'correct': True, 'seed': seed}\n")
    assert manifest.driver("toy", here=tmp_path).run(None, 5, 1, False, device="cpu",
                                                     t_start=0)["seed"] == 5
    cell = file_cell_entry()
    assert manifest.runner(cell).__module__ == "perfbench_driver_file_sort"
    assert [m["name"] for m in cell.end_to_end] == ["sort_Mrec_s", "peak_GiB", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {*READERS, "device_idle_pct"}
    for src in ("run.py", "manifest.py", "control.py", "harness.py"):
        assert "file_sort" not in (manifest.HERE / src).read_text(), src


def _stats(**kw):
    from repro_torch.core.stages.stats import SortStats

    return SortStats(input_bytes=1000, **kw)


def test_the_readers_of_sort_stats():
    drv = manifest.driver("file_sort")
    ctx = drv.FileContext(
        config={}, device_name="cpu", calls=[harness.Call(10, 2.0, False)] * 2, window_s=4.0,
        setup_s=3.0, peak_bytes=0, base_bytes=0, trace=None, port_kernels=set(),
        stats=[_stats(phase_seconds={"partition": 1.0, "sort": 2.0, "write": 0.5},
                      phase_wall_seconds={"partition": 9.0, "sort": 9.0, "write": 9.0},
                      batch_occupancy=0.5, spill_disk_bytes=800),
               _stats(phase_seconds={"partition": 3.0, "sort": 4.0, "write": 1.5},
                      phase_wall_seconds={"partition": 9.0, "sort": 9.0, "write": 9.0},
                      batch_occupancy=0.7, spill_disk_bytes=600)])
    read = {m: manifest.reader(m)(ctx) for m in READERS}
    assert read == pytest.approx({"partition_s": 2.0, "sort_stage_s": 3.0, "write_s": 1.0,
                                  "batch_occupancy_pct": 60.0, "spill_disk_pct": 70.0})
    assert manifest.reader("sort_Mrec_s")(ctx) == pytest.approx(20 / 4.0 / 1e6)
    assert manifest.reader("device_idle_pct")(ctx) is None
    tr = trace.Trace(window_s=10.0, busy_s=0.05, device=[], idle_by_host={})
    assert manifest.reader("device_idle_pct")(
        dataclasses.replace(ctx, trace=tr)) == pytest.approx(99.5)
    none = dataclasses.replace(ctx, stats=[None, None])
    for m in read:
        assert manifest.reader(m)(none) is None
    assert manifest.reader("batch_occupancy_pct")(
        dataclasses.replace(ctx, stats=[_stats()])) is None
    assert manifest.reader("write_s")(
        dataclasses.replace(ctx, stats=[_stats(phase_seconds={"sort": 1.0})])) is None


def test_the_input_is_read_warm(file_cell):
    cell = file_cell()
    assert cell.traffic["page_cache"] == "warm"
    cell.traffic["page_cache"] = "cold"
    with pytest.raises(ValueError, match="page_cache"):
        _run(cell)
