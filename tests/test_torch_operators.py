"""Port parity of the merge-free operators: ``repro_torch.core.operators``
on the CPU must write what ``repro.core.operators`` writes — the
co-partitioned sorted runs, join (inner and left) / dedup (first-wins
and counts) / group-by (count and sum) outputs byte for byte, and v3
manifests with the same ``model_hash`` — over a reduced grid of
``tests/test_operators.py``: fixed and line records × join selectivity
{0, 0.1, 1.0}, dedup and group-by at duplicate factors {1, 16, 256},
the forced spill fallback, misaligned runs refused, and
``verify_co_partitioning`` with and without ``use_kernels``.  Plus one
CLI join with ``--device cpu``.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import manifest as jman  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core.format import LineFormat as JLineFormat  # noqa: E402
from repro.data import lines as jlines  # noqa: E402
from repro_torch.core import manifest as tman  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.format import LineFormat  # noqa: E402
from repro_torch.data import lines as tlines  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BUDGET = 1 << 20
N = {"line": 4_000, "fixed": 2_000}
K = jlines.KEYED_KEY_BYTES
V = jlines.KEYED_VALUE_BYTES
SORT = dict(memory_budget_bytes=BUDGET, n_partitions=5)


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _fmt(package: str, fmt_kind: str):
    if fmt_kind == "fixed":
        return None
    return (JLineFormat if package == "jax" else LineFormat)(max_key_bytes=K)


def _write(path, fmt_kind, n, key_space, key_offset, seed):
    gen = tlines.write_keyed_lines if fmt_kind == "line" else (
        tlines.write_keyed_records
    )
    gen(path, n, key_space=key_space, key_offset=key_offset, seed=seed)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("tops")


_CACHE: dict = {}


def _sorted(workdir, name: str, raws: "list[str]", fmt_kind: str):
    """Co-partition-sort ``raws`` with each package once; returns
    ``{package: [sorted paths]}``."""
    if name not in _CACHE:
        runs = {}
        for package, mod in (("jax", jops), ("torch", tops)):
            outs = [f"{p}.{package}.s" for p in raws]
            kw = {} if package == "jax" else {"device": "cpu"}
            mod.sort_co_partitioned(
                raws, outs, fmt=_fmt(package, fmt_kind), **SORT, **kw
            )
            runs[package] = outs
        for a, b in zip(runs["jax"], runs["torch"]):
            assert _sha(a) == _sha(b), f"sorted runs differ: {name}"
            assert (tman.load(tman.manifest_path(b)).model_hash
                    == jman.load(jman.manifest_path(a)).model_hash)
        _CACHE[name] = runs
    return _CACHE[name]


def _join_runs(workdir, fmt_kind, sel):
    n = N[fmt_kind]
    key_space = n // 4
    loff, roff = tlines.join_offsets(key_space, sel)
    a = str(workdir / f"{fmt_kind}_{sel}_a")
    b = str(workdir / f"{fmt_kind}_{sel}_b")
    if not _CACHE.get(a):
        _write(a, fmt_kind, n, key_space, loff, seed=11)
        _write(b, fmt_kind, n * 3 // 4, key_space, roff, seed=23)
        _CACHE[a] = True
    return _sorted(workdir, f"join_{fmt_kind}_{sel}", [a, b], fmt_kind)


def _dup_run(workdir, fmt_kind, dup):
    n = N[fmt_kind] // 2
    p = str(workdir / f"{fmt_kind}_dup{dup}")
    if not _CACHE.get(p):
        _write(p, fmt_kind, n, max(1, n // dup), 0, seed=31)
        _CACHE[p] = True
    return _sorted(workdir, f"dup_{fmt_kind}_{dup}", [p], fmt_kind)


def _assert_same_output(jout, tout):
    assert _sha(tout) == _sha(jout)
    jm = jman.load(jman.manifest_path(jout))
    tm = tman.load(tman.manifest_path(tout))
    assert tm.model_hash == jm.model_hash and tm.version == 3
    np.testing.assert_array_equal(tm.part_counts, jm.part_counts)


@pytest.mark.parametrize("sel", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_join_equal_jax(workdir, tmp_path, fmt_kind, sel):
    runs = _join_runs(workdir, fmt_kind, sel)
    for how in ("inner", "left"):
        outs = {}
        for package, mod in (("jax", jops), ("torch", tops)):
            outs[package] = str(tmp_path / f"{package}_{how}.out")
            st = mod.external_join(
                *runs[package], outs[package], how=how,
                memory_budget_bytes=BUDGET, verify=True,
            )
            assert sum(st.part_counts) == st.n_out
        _assert_same_output(outs["jax"], outs["torch"])


@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_join_forced_spill_equal_jax(workdir, tmp_path, fmt_kind):
    runs = _join_runs(workdir, fmt_kind, 1.0)
    outs = {}
    for package, mod in (("jax", jops), ("torch", tops)):
        outs[package] = str(tmp_path / f"{package}.out")
        st = mod.external_join(*runs[package], outs[package],
                               memory_budget_bytes=BUDGET, chunk_records=7)
        assert st.spill_fallbacks > 0
    _assert_same_output(outs["jax"], outs["torch"])


@pytest.mark.parametrize("dup", [1, 16, 256])
@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_dedup_groupby_equal_jax(workdir, tmp_path, fmt_kind, dup):
    runs = _dup_run(workdir, fmt_kind, dup)
    vs = K if fmt_kind == "line" else 10
    cases = [
        ("dedup", dict(counts=False)), ("dedup", dict(counts=True)),
        ("groupby", dict(agg="count")),
        ("groupby", dict(agg="sum", value_offset=vs, value_width=V)),
    ]
    for k, (op, kw) in enumerate(cases):
        outs = {}
        for package, mod in (("jax", jops), ("torch", tops)):
            outs[package] = str(tmp_path / f"{package}_{k}.out")
            # chunk_records small enough that key runs straddle chunks
            getattr(mod, f"external_{op}")(
                runs[package][0], outs[package], memory_budget_bytes=BUDGET,
                chunk_records=13, **kw,
            )
        _assert_same_output(outs["jax"], outs["torch"])


def test_misaligned_runs_refused(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write(a, "line", 3_000, 500, 0, seed=1)
    _write(b, "line", 3_000, 500, 0, seed=2)
    for p in (a, b):  # separate sorts -> independently trained models
        tops.sort_co_partitioned([p], [p + ".s"], fmt=LineFormat(
            max_key_bytes=K), memory_budget_bytes=BUDGET, device="cpu")
    with pytest.raises(ValueError, match="different models"):
        tops.external_join(a + ".s", b + ".s", str(tmp_path / "j.out"),
                           memory_budget_bytes=BUDGET)


@pytest.mark.parametrize("fmt_kind", ["fixed", "line"])
def test_verify_co_partitioning_equal_jax(workdir, fmt_kind):
    """The NumPy predictor, the RMI kernel's plain version through
    ``rmi_bucket_pair`` (one call for both inputs) and the reference
    agree on every boundary key; a moved boundary names the key."""
    runs = _join_runs(workdir, fmt_kind, 0.1)
    jl, jr = (jops._Run.open(p) for p in runs["jax"])
    tl, tr = (tops._Run.open(p) for p in runs["torch"])
    want = jops.verify_co_partitioning(jl, jr)
    assert want > 0
    assert tops.verify_co_partitioning(tl, tr) == want
    ops.reset_launches()
    assert tops.verify_co_partitioning(
        tl, tr, use_kernels=True, device="cpu"
    ) == want
    assert ops.rmi_bucket.launches == 0  # the plain version launches none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.verify_co_partitioning(tl, tr, use_kernels=True)
    # a right run whose partition 0 claims one more record than it holds
    starts = tr.starts.copy()
    starts[1] += 1
    tr.starts = starts
    with pytest.raises(AssertionError, match=r"boundary key b'.*' of "
                                             r"partition 0 re-buckets"):
        tops.verify_co_partitioning(tl, tr, use_kernels=True, device="cpu")


def test_rmi_bucket_pair_splits_one_call():
    from repro_torch.core import encoding, rmi as trmi
    from repro_torch.data import gensort

    keys = gensort.uniform_keys(300, seed=2)
    model = trmi.fit(keys, n_leaf=16)
    hi, lo = (torch.from_numpy(w.astype(np.int64))
              for w in encoding.encode_np(keys))
    a, b = ops.rmi_bucket_pair(model, hi[:120], lo[:120], hi[120:],
                               lo[120:], 7)
    whole = ops.rmi_bucket(model, hi, lo, 7)
    assert torch.equal(torch.cat([a, b]), whole) and a.shape == (120,)


def test_ops_cli_join_device_cpu(tmp_path, capsys):
    from repro.launch import ops as jcli
    from repro_torch.launch import ops as tcli

    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    tlines.write_keyed_lines(a, 2_000, key_space=500, seed=5)
    tlines.write_keyed_lines(b, 2_000, key_space=500, key_offset=250, seed=6)
    outs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.txt")
        cli.main([
            "join", "--left", a, "--right", b, "--output", outs[name],
            "--line", "--budget-mb", "1", "--readers", "2", "--verify",
            "--use-kernels", "--workdir", str(tmp_path / f"w_{name}"),
            *extra,
        ])
    _assert_same_output(outs["jax"], outs["torch"])
    assert "join_inner: 2000 x 2000" in capsys.readouterr().out
