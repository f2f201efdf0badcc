"""Port parity end to end: ``repro_torch.core.external.sort_file`` on the
CPU must write the same bytes (sha256) as ``repro.core.external.sort_file``
and take the same planner decision and partition counts, over gensort
uniform and skewed corpora × readers {1, 3} × writers {1, 4} × forced
spill × executor {host, batched grid}.  Plus the import hygiene of the
port: it runs with neither ``jax`` nor ``repro`` importable.
"""

import hashlib
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.core import external as jext  # noqa: E402
from repro.data import gensort  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import validate as tvalidate  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.data import gensort as tgensort  # noqa: E402

N = 4_000
BUDGET = 1 << 20
SPILLS = {
    "coalesced": {},
    "forced_spill": {
        "n_partitions": 16,
        "batch_records": 1500,
        "flush_bytes": 4 << 10,
    },
}
# executor axis: the host LearnedSort, and the batched executor on the
# grid graph (kernels' plain versions on the CPU)
EXECUTORS = {
    "host": {"executor": "host"},
    "batched_grid": {"executor": "batched", "use_kernels": True},
}


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


_CACHE: dict = {}


def _reference(tmp_path_factory, shape: str, spill: str):
    """(input path, JAX stats, JAX output sha), once per corpus/spill."""
    key = (shape, spill)
    if key not in _CACHE:
        d = tmp_path_factory.mktemp(f"ref_{shape}_{spill}")
        inp = str(d / "in.bin")
        gensort.write_file(inp, N, skewed=shape == "skewed", seed=3)
        out = str(d / "jax.bin")
        stats = jext.sort_file(
            inp, out, config=jext.SortConfig(memory_budget_bytes=BUDGET),
            **SPILLS[spill],
        )
        _CACHE[key] = (inp, stats, _sha(out))
    return _CACHE[key]


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("spill", sorted(SPILLS))
@pytest.mark.parametrize("n_writers", [1, 4])
@pytest.mark.parametrize("n_readers", [1, 3])
@pytest.mark.parametrize("shape", ["uniform", "skewed"])
def test_sort_file_bytes_equal_jax(
    tmp_path_factory, tmp_path, shape, n_readers, n_writers, spill, executor
):
    inp, jstats, jsha = _reference(tmp_path_factory, shape, spill)
    out = str(tmp_path / "torch.bin")
    stats = text.sort_file(
        inp, out,
        config=SortConfig(memory_budget_bytes=BUDGET, device="cpu"),
        n_readers=n_readers, n_writers=n_writers,
        **SPILLS[spill], **EXECUTORS[executor],
    )
    assert _sha(out) == jsha
    assert stats.planner_decision == jstats.planner_decision
    assert stats.partition_counts == jstats.partition_counts
    assert stats.n_records == N
    assert stats.executor == EXECUTORS[executor]["executor"]
    if executor == "batched_grid":
        assert stats.device_dispatches > 0
    refsum = tvalidate.checksum(tgensort.read_records(inp, mmap=False))
    assert tvalidate.validate_file(out, refsum, N)["ok"]


def test_default_device_is_cuda():
    from repro_torch.core.config import ExecutorConfig

    assert SortConfig().device == "cuda"
    assert ExecutorConfig().device == "cuda"


def test_cuda_requested_without_a_card_raises(tmp_path_factory, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inp, _, _ = _reference(tmp_path_factory, "uniform", "coalesced")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.sort_file(inp, str(tmp_path / "o.bin"), config=SortConfig())


def test_unported_features_raise(tmp_path_factory, tmp_path):
    """A mesh of more than one axis (the LM step's ``DeviceMesh``) needs
    as many ranks as its shape holds: a process without a process group
    is refused.  The mesh executor (see tests/test_torch_mesh_executor.py):
    ``sort_file`` under it writes the reference's bytes."""
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(ValueError, match=r"needs 256 ranks, the process group has 1"):
        make_mesh((16, 16), ("data", "model"), device="cpu")
    inp, _, jsha = _reference(tmp_path_factory, "uniform", "coalesced")
    out = str(tmp_path / "o.bin")
    stats = text.sort_file(
        inp, out, config=SortConfig(memory_budget_bytes=BUDGET, device="cpu"),
        executor="mesh", **SPILLS["coalesced"],
    )
    assert stats.executor == "mesh"
    assert _sha(out) == jsha


def test_port_imports_without_jax_or_repro():
    """``repro_torch`` never imports ``jax`` or ``repro``: with both made
    unimportable, every module of the package still loads."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("repro_torch.serve.server", "repro_torch.core.operators",
                     "repro_torch.launch.ops", "repro_torch.core.terasort",
                     "repro_torch.core.distributed", "repro_torch.launch.mesh"):
            assert name in names, names
        bad = [m for m in sys.modules
               if (m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
        """
    )
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={**os.environ, "PYTHONPATH": src},
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
