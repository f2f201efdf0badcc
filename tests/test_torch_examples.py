"""The port's examples (``examples/torch_*.py``) run as a user runs them,
each in a subprocess with ``--device cpu`` at its small size, all four
at once, and checked as ``chip_smoke.py``'s examples phase checks them
on the card: the quickstart's output validates and has the host
executor's bytes for the same seed; the demo's global order is
``np.lexsort``'s with nothing lost; serving emits finite logits; the
trained loss falls.  Without a card each one's default ``--device
cuda`` fails before any work, with no result line."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import external, validate  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.data import gensort  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
QUICK_RECORDS = 20_000


def _run(name: str, *args: str, **popen) -> subprocess.Popen:
    # one thread each: the examples run at once, beside the other test files
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name), *args],
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, **popen)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    procs = {
        "quickstart": _run("torch_quickstart.py", str(QUICK_RECORDS), "2", "--device", "cpu",
                           "--workdir", str(tmp / "quick")),
        "demo": _run("torch_distributed_sort_demo.py", "--tiny", "--device", "cpu"),
        "serve": _run("torch_serve_lm.py", "--tiny", "--device", "cpu"),
        "train": _run("torch_train_lm.py", "--tiny", "--device", "cpu",
                      "--ckpt-dir", str(tmp / "ckpt")),
    }
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=300)
            assert p.returncode == 0, f"{name}: {se[-4000:]}"
            out[name] = json.loads(so.strip().splitlines()[-1 if name != "train" else -2])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_quickstart_validates_with_the_host_executors_bytes(runs, tmp_path):
    res = runs["quickstart"]
    assert res["ok"] and res["records"] == QUICK_RECORDS
    chk = validate.checksum(gensort.read_records(res["input"], mmap=False))
    assert validate.validate_file(res["output"], chk, QUICK_RECORDS)["ok"]
    host = str(tmp_path / "host.sorted")
    external.sort_file(res["input"], host, config=SortConfig(
        memory_budget_bytes=64 << 20, executor="host", device="cpu"))
    with open(host, "rb") as a, open(res["output"], "rb") as b:
        assert a.read() == b.read()
    assert not any(res["launches"].values())  # the plain versions on the CPU


def test_demo_sorts_globally_without_loss(runs):
    res = runs["demo"]
    assert res["ok"] and res["lost"] == 0 and res["ranks"] == 2
    assert sum(res["n_valid"]) == res["records"] == 1 << 14
    assert res["devices"] == ["cpu", "cpu"]


def test_serve_emits_finite_logits(runs):
    res = runs["serve"]
    assert res["logits_finite"] and res["repeatable"] and res["shape"] == [2, 4]


def test_train_loss_falls(runs):
    res = runs["train"]
    assert res["steps"] == 20 and res["last_loss"] < res["first_loss"]


DEFAULTS = {"torch_quickstart.py": (), "torch_distributed_sort_demo.py": (),
            "torch_serve_lm.py": (), "torch_train_lm.py": ("--tiny",)}


@pytest.fixture(scope="module")
def no_card(tmp_path_factory):
    """Each example with its default device, all at once, on a host
    without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    tmp = tmp_path_factory.mktemp("no_card")
    procs = {name: _run(name, *args, cwd=str(tmp)) for name, args in DEFAULTS.items()}
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=120)
            out[name] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_default_device_is_the_card(no_card, name):
    rc, so, se = no_card[name]
    assert rc != 0 and "no CUDA device" in se
    assert not any(line.startswith("{") for line in so.splitlines())
