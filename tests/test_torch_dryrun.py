"""The port's dry run (``repro_torch.launch.dryrun.run_cell``) on a
``(2, 2)`` fake process group at smoke size: one dense arch (qwen3-4b),
one MoE (mixtral-8x7b), the hybrid (jamba: Mamba + MoE), the
encoder-decoder (whisper-medium) and the recurrent xlstm-350m (its
sLSTM loop and token-by-token prefill counted one step for all,
``models/recurrence.scan``), each through its train step (8
microbatches), prefill and decode step, at small shapes named as the
registry's.  Every cell is ``"status": "ok"`` with the reference's keys
(``tests``' view of ``src/repro/launch/dryrun.py``), positive FLOPs and
bytes, and CUDA is never initialised.  The fake process group is global
to its process, so each arch runs in a subprocess of its own (all five
at once).  Plus the cells the reference skips, skipped, and the CLI's
rerun skipping the cells already written."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCHS = ["qwen3-4b", "mixtral-8x7b", "jamba-v0.1-52b", "whisper-medium", "xlstm-350m"]
KEYS = {"arch", "shape", "mesh", "status", "n_chips", "trace_s", "flops_per_device",
        "bytes_accessed_per_device", "collectives", "memory"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}

CELLS = r"""
import json, sys, torch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, mesh as M
M.init_fake_process_group(4)
mesh = M.make_device_mesh((2, 2), ("data", "model"), device="cpu")
arch = sys.argv[1]
shapes = [ShapeConfig("train_4k", "train", 64, 16), ShapeConfig("prefill_32k", "prefill", 64, 4),
          ShapeConfig("decode_32k", "decode", 64, 4), ShapeConfig("long_500k", "decode", 64, 1)]
out = [dryrun.run_cell(arch, s.name, "single", smoke=True, mesh=mesh, shape=s) for s in shapes]
print("RESULT " + json.dumps({"cells": out, "cuda": torch.cuda.is_initialized()}))
"""


@pytest.fixture(scope="module")
def cells():
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = {a: subprocess.Popen([sys.executable, "-c", CELLS, a], env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a in ARCHS}
    out = {}
    try:
        for a, p in procs.items():
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, se[-4000:]
            line = [s for s in so.splitlines() if s.startswith("RESULT ")][-1]
            out[a] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_trace_with_the_reference_keys(cells, arch):
    res = cells[arch]
    assert not res["cuda"]
    for cell in res["cells"]:
        if cell["status"] == "skipped":  # long_500k: full-attention archs
            assert cell["shape"] == "long_500k" and "long_500k" in cell["reason"]
            continue
        assert cell["status"] == "ok", cell
        assert set(cell) == KEYS and set(cell["memory"]) == MEMORY, cell
        assert cell["n_chips"] == 4
        assert cell["flops_per_device"] > 0 and cell["bytes_accessed_per_device"] > 0
        assert all(set(v) == {"count", "result_bytes", "max_group"}
                   for v in cell["collectives"].values())
        assert max(v["max_group"] for v in cell["collectives"].values()) == 2
        mem = cell["memory"]
        assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
        if cell["shape"] == "train_4k":  # parameters and state updated in place
            assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    skipped = [c["shape"] for c in res["cells"] if c["status"] == "skipped"]
    assert skipped == ([] if arch in ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-350m")
                       else ["long_500k"])


def test_cli_skips_what_is_written(tmp_path):
    """``--out`` cells already written are skipped, as the reference's
    ``[skip existing]``; a cell the reference skips is written skipped."""
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    (tmp_path / "qwen3-4b__prefill_32k__single.json").write_text("{}")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(tmp_path),
           "--mesh", "single"]
    out = subprocess.run(cmd + ["--arch", "qwen3-4b", "--shape", "prefill_32k"], env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert "[skip existing] qwen3-4b__prefill_32k__single" in out
    subprocess.run(cmd + ["--arch", "qwen3-4b", "--shape", "long_500k"], env=env,
                   capture_output=True, text=True, timeout=120, check=True)
    rec = json.loads((tmp_path / "qwen3-4b__long_500k__single.json").read_text())
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
