"""A run with the timed path broken underneath comes out not correct:
the controls, and each fault a one-chip sort cell can have.  On the CPU
the harness's look for a chip is skipped (``device="cpu"``) and the rest
of a run is driven as it is; the marked test runs the same on the card."""

import time

import pytest
import torch

from perfbench import controls, harness

CELLS = ("gensort-uniform.hbm-arrays", "gensort-skew.hbm-arrays")


def _run(cell, sort, device="cpu", seed=2**35 + 3):
    return harness.run_cell(cell, seed, 0.3, False, device=device,
                            t_start=time.perf_counter(), sort=sort)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(tiny_cell, name):
    r = _run(tiny_cell(name), None)
    assert r["correct"] and r["failed"] == 0
    assert list(r["checks"]) == ["perm_bad", "words_bad", "order_bad", "ties_bad"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [f for f in controls.FAULTS if f != "unstable"])
def test_each_fault_is_caught(tiny_cell, name, fault):
    r = _run(tiny_cell(name), controls.fault(fault, harness.program_sort()))
    assert not r["correct"] and r["failed"] >= 1


def test_an_unstable_order_is_caught(tiny_cell):
    # a few thousand uniform keys hold no equal 8-byte prefixes; skewed ones do
    r = _run(tiny_cell("gensort-skew.hbm-arrays"), controls.fault("unstable", None))
    assert not r["correct"] and r["checks"]["ties_bad"]["value"] > 0
    assert r["checks"]["order_bad"]["value"] == 0


@pytest.mark.parametrize("seed", range(1, 7))
@pytest.mark.parametrize(
    "name,fault",
    [("gensort-uniform.hbm-arrays", "rows"), ("gensort-skew.hbm-arrays", "rows"),
     ("gensort-skew.hbm-arrays", "fallback")],
)
def test_a_fault_in_one_path_is_caught_on_every_seed(tiny_cell, name, fault, seed):
    # skewed arrays take both paths, call by call; whichever calls the seed
    # draws, the first call down each path is checked too
    planted = controls.fault(fault, harness.program_sort())
    paths = []

    def sort(model, keys):
        out = planted(model, keys)
        paths.append(harness.PATHS[bool(out[3])])
        return out

    r = _run(tiny_cell(name), sort, seed=seed)
    assert fault in paths
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("key", controls.CONTROLS)
def test_the_control_is_caught(tiny_cell, key):
    # a few thousand uniform keys share no 4-byte prefix; skewed ones do
    r = _run(tiny_cell("gensort-skew.hbm-arrays"), controls.control(key))
    assert not r["correct"] and r["checks"]["order_bad"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", controls.CONTROLS + controls.FAULTS + ("fallback",))
def test_on_the_card(tiny_cell, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell("gensort-skew.hbm-arrays")
    cell.config.update(file_records=1 << 30, records_per_call_max=1 << 27, n_leaf=65536)
    cell.traffic.update(sizes=[1 << 22, 1 << 23])
    assert _run(cell, None, "cuda")["correct"]
    r = _run(cell, controls.sort_for(path, harness.program_sort()), "cuda")
    assert not r["correct"]
