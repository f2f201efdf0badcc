"""Port parity over the differential grids of ``tests/test_differential.py``:
``repro_torch.core.external.sort_file`` on the CPU must write the bytes
(sha256) of ``repro.core.external.sort_file`` and take its planner
decision, on line corpora (uniform — without its final newline —,
skewed, dups, short, empty) and on the adversarial grid (fixed and
line records × presorted, reverse, zipf, allequal, tiny, plus utf8
lines), under forced spill pressure, with the host executor and the
batched executor's grid graph.  Corpora come from the port's own
generators; their bytes equal the reference's (``test_torch_lines.py``).
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

from repro.core import external as jext  # noqa: E402
from repro.core.format import LineFormat as JLineFormat  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import validate as tvalidate  # noqa: E402
from repro_torch.core.config import SortConfig  # noqa: E402
from repro_torch.core.format import GENSORT, LineFormat  # noqa: E402
from repro_torch.data import gensort, lines  # noqa: E402

K = 16  # LineFormat key window, as in the reference's grid
N_LINE, N_FIXED = 3_000, 2_000
# forced spill: many partitions and small (stripe, seq) fragments
KNOBS = dict(memory_budget_bytes=1 << 20, n_partitions=16,
             batch_records=1500, flush_bytes=4 << 10)
EXECUTORS = {
    "host": {"executor": "host"},
    "batched_grid": {"executor": "batched", "use_kernels": True},
}
CORPORA = (
    [("line", s) for s in ("uniform", "skewed", "dups", "short", "empty")]
    + [(f, s) for f in ("fixed", "line")
       for s in ("presorted", "reverse", "zipf", "allequal", "tiny")]
    + [("line", "utf8")]
)


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


_CACHE: dict = {}


def _reference(tmp_path_factory, fmt_kind: str, shape: str):
    """(input, JAX sha, JAX stats, n, input checksum), once per corpus."""
    key = (fmt_kind, shape)
    if key not in _CACHE:
        d = tmp_path_factory.mktemp(f"{fmt_kind}_{shape}")
        inp, out = str(d / "in"), str(d / "jax.out")
        if fmt_kind == "fixed":
            gensort.write_adversarial_file(inp, N_FIXED, shape, seed=13)
            n, jfmt = N_FIXED, None
        else:
            adversarial = shape in lines.ADVERSARIAL_KINDS
            # plain "uniform" also drops the final newline: the sorter
            # must normalize it exactly as GNU sort does
            lines.write_lines(inp, N_LINE, kind=shape,
                              seed=13 if adversarial else 5,
                              terminate_last=shape != "uniform")
            n, jfmt = N_LINE, JLineFormat(max_key_bytes=K)
        st = jext.sort_file(inp, out, config=jext.SortConfig(fmt=jfmt, **KNOBS))
        fmt = LineFormat(max_key_bytes=K) if jfmt else GENSORT
        refsum = tvalidate.checksum_block(fmt.read_block(inp))
        _CACHE[key] = (inp, _sha(out), st, n, refsum)
    return _CACHE[key]


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("fmt_kind,shape", CORPORA)
def test_differential_bytes_equal_jax(
    tmp_path_factory, tmp_path, fmt_kind, shape, executor
):
    inp, jsha, jstats, n, refsum = _reference(tmp_path_factory, fmt_kind,
                                              shape)
    fmt = LineFormat(max_key_bytes=K) if fmt_kind == "line" else None
    out = str(tmp_path / "torch.out")
    stats = text.sort_file(inp, out, config=SortConfig(
        fmt=fmt, device="cpu", **KNOBS, **EXECUTORS[executor]
    ))
    assert _sha(out) == jsha, f"{fmt_kind}/{shape}/{executor}"
    assert stats.planner_decision == jstats.planner_decision
    assert stats.planner_reason == jstats.planner_reason
    assert stats.partition_counts == jstats.partition_counts
    assert stats.n_records == n and stats.executor == executor.split("_")[0]
    assert tvalidate.validate_file(out, refsum, n, fmt=fmt or GENSORT)["ok"]
