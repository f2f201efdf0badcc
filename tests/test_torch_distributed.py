"""Port parity of ``repro_torch.core.distributed``: ``make_sort_fn`` over
8 gloo ranks (spawned with a ``file://`` store and a hard timeout) held
to the reference's ``make_sort_fn`` run over 8 fake XLA devices in a
subprocess (``XLA_FLAGS`` set there, as ``tests/test_distributed_sort.py``
does), on the same inputs: gensort keys, uniform and skewed (the cases
of ``tests/test_distributed_sort.py``), and the contiguous duplicate
spike of ``tests/test_overflow_fallback.py`` with and without the
decorrelation shuffle.  The global ``(hi, lo)`` order must be the
reference's, the payloads of each key the same multiset, ``lost`` the
reference's, and ``lost`` and ``n_valid`` equal to the counts the
reference's eager ``predict_bucket`` gives (its router is jitted, so
its own ids may differ at an exact boundary: hazard b).  At world size 1
the port runs in this process and is held to the reference's 1-device
mesh.  Plus the data mesh's own contract (``launch/mesh.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.partition import route_capacity  # noqa: E402
from repro.launch.mesh import make_data_mesh as jmesh  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import encoding as tenc  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.encoding import SENTINEL  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
N_DEV = 8
CASES = ("uniform", "skewed", "spike", "spike_noshuffle")
# run by the port alone: the reference counts a real key of SENTINEL
# words as padding and drops it
PORT_CASES = ("sentinel_keys",)
FACTOR = 1.5


def _inputs(case: str):
    """(hi, lo, model sample, n_leaf, pre_shuffle) of a case: u32 words."""
    if case in ("uniform", "skewed", "sentinel_keys"):
        n = 1 << 15
        recs = gensort.make_records(n, skewed=case == "skewed")
        if case == "sentinel_keys":  # keys with the padding's words
            ff = np.random.default_rng(2).choice(n, 300, replace=False)
            recs[ff, :8] = 0xFF
        hi, lo = tenc.encode_np(recs[:, :10])
        pick = np.random.default_rng(1).choice(n, 2048, replace=False)
        return hi, lo, recs[pick, :10], 2048, True
    # a duplicate spike laid out contiguously: rank 0's whole shard is
    # one key, all bound for one rank
    n = 1 << 14
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    hi[: n // 8] = 77
    lo[: n // 8] = 77
    pick = rng.choice(n, 2048, replace=False)
    return hi, lo, (hi[pick], lo[pick]), 512, case == "spike"


def _fit(fit_mod, sample, n_leaf):
    if isinstance(sample, tuple):
        return fit_mod.fit_encoded(*sample, n_leaf=n_leaf)
    return fit_mod.fit(sample, n_leaf=n_leaf)


def _eager(case: str, n_dev: int):
    """(lost per rank, n_valid per rank) from the reference's eager
    ``predict_bucket``: each rank's send counts after the shuffle, capped
    at the route capacity."""
    hi, lo, sample, n_leaf, shuffle = _inputs(case)
    n = hi.shape[0]
    k = n // n_dev
    b = np.asarray(jrmi.predict_bucket(
        _fit(jrmi, sample, n_leaf), jnp.asarray(hi), jnp.asarray(lo), n_dev
    ))
    shards = b.reshape(n_dev, k)
    if shuffle:  # rank j holds block j of every source shard
        shards = shards.reshape(n_dev, n_dev, -1).transpose(1, 0, 2)
        shards = shards.reshape(n_dev, k)
    cap = route_capacity(k, n_dev, FACTOR)
    counts = np.stack([np.bincount(s, minlength=n_dev) for s in shards])
    lost = np.maximum(counts - cap, 0).sum(1)
    n_valid = np.minimum(counts, cap).sum(0)
    return lost, n_valid


def _global(res):
    return [np.asarray(res[k]) for k in ("gh", "gl", "gv")]


def _per_key_payloads(gh, gl, gv):
    """The payloads sorted within each run of equal keys."""
    return gv[np.lexsort((gv, gl, gh))]


# Both packages run each case from the same saved inputs: ``hi``/``lo``
# u32 words, the model's sample (keys, or words for ``fit_encoded``),
# its leaf count and whether the shuffle runs.
LOAD = r"""
def load(case):
    z = np.load(os.path.join(os.environ["INPUTS"], case + ".npz"))
    n_leaf = int(z["n_leaf"])
    if z["encoded"]:
        model = rmi.fit_encoded(*z["sample"], n_leaf=n_leaf)
    else:
        model = rmi.fit(z["sample"], n_leaf=n_leaf)
    return z["hi"], z["lo"], model, bool(z["shuffle"])
"""

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import distributed, rmi
from repro.launch.mesh import make_mesh
""" + LOAD + r"""
mesh = make_mesh((8,), ("data",))
sh = NamedSharding(mesh, P("data"))
for case in os.environ["CASES"].split(","):
    hi, lo, model, shuffle = load(case)
    n = hi.shape[0]
    fn = distributed.make_sort_fn(
        mesh, ("data",), model, n_per_device=n // 8,
        capacity_factor=float(os.environ["FACTOR"]), use_kernels=False,
        pre_shuffle=shuffle)
    out = fn(*(jax.device_put(jnp.asarray(a), sh)
               for a in (hi, lo, np.arange(n, dtype=np.int32))))
    gh, gl, gv = distributed.global_sorted_from_shards(*out[:4], 8)
    np.savez(os.path.join(os.environ["OUT"], case + ".npz"), gh=gh, gl=gl,
             gv=gv, n_valid=np.asarray(out[3]), lost=np.asarray(out[4]))
print("JAX_OK")
"""

GLOO_SCRIPT = r"""
import os
import numpy as np, torch
from repro_torch.core import distributed, rmi
from repro_torch.launch import mesh as M
""" + LOAD + r"""
M.initialize_multiprocess("file://" + os.environ["STORE"],
                          int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), device="cpu", timeout_s=60)
mesh = M.make_data_mesh(device="cpu")
for case in os.environ["CASES"].split(","):
    hi, lo, model, shuffle = load(case)
    n = hi.shape[0]
    k = n // mesh.world_size
    s = slice(mesh.rank * k, (mesh.rank + 1) * k)
    fn = distributed.make_sort_fn(
        mesh, ("data",), model, n_per_device=k,
        capacity_factor=float(os.environ["FACTOR"]), pre_shuffle=shuffle)
    out = fn(torch.from_numpy(hi[s].astype(np.int64)),
             torch.from_numpy(lo[s].astype(np.int64)),
             torch.arange(n, dtype=torch.int32)[s])
    full = [mesh.all_gather(t) for t in out]
    if mesh.rank == 0:
        gh, gl, gv = distributed.global_sorted_from_shards(*full[:4], 8)
        np.savez(os.path.join(os.environ["OUT"], case + ".npz"), gh=gh,
                 gl=gl, gv=gv, n_valid=full[3].numpy(), lost=full[4].numpy())
print("GLOO_OK")
M.exit_rank()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's outputs of every case, once."""
    d = tmp_path_factory.mktemp("dist")
    inputs, jax_out, torch_out = d / "in", d / "jax", d / "torch"
    for p in (inputs, jax_out, torch_out):
        p.mkdir()
    for case in CASES + PORT_CASES:
        hi, lo, sample, n_leaf, shuffle = _inputs(case)
        encoded = isinstance(sample, tuple)
        np.savez(inputs / f"{case}.npz", hi=hi, lo=lo,
                 sample=np.stack(sample) if encoded else sample,
                 encoded=encoded, n_leaf=n_leaf, shuffle=shuffle)
    env = {"PYTHONPATH": SRC, "INPUTS": str(inputs), "CASES": ",".join(CASES),
           "FACTOR": str(FACTOR)}
    ref_env = {**os.environ, **env, "OUT": str(jax_out)}
    ref_env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT], env=ref_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        tmesh.spawn(GLOO_SCRIPT, N_DEV, timeout_s=120, env={
            **env, "STORE": str(d / "store"), "OUT": str(torch_out),
            "CASES": ",".join(CASES + PORT_CASES),
        })
        out, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "JAX_OK" in out, err[-4000:]
    load = lambda p, c: dict(np.load(p / f"{c}.npz"))  # noqa: E731
    res = {c: (load(jax_out, c), load(torch_out, c)) for c in CASES}
    res.update({c: (None, load(torch_out, c)) for c in PORT_CASES})
    return res


@pytest.mark.parametrize("case", CASES)
def test_global_order_equals_reference(runs, case):
    ref, got = runs[case]
    gh, gl, _ = _global(got)
    rh, rl, _ = _global(ref)
    np.testing.assert_array_equal(gh, rh)
    np.testing.assert_array_equal(gl, rl)
    hi, lo, *_ = _inputs(case)
    if case != "spike_noshuffle":  # nothing lost: every record, in order
        o = np.lexsort((lo, hi))
        np.testing.assert_array_equal(gh, hi[o])
        np.testing.assert_array_equal(gl, lo[o])


@pytest.mark.parametrize("case", CASES)
def test_payloads_of_each_key_equal_reference(runs, case):
    ref, got = runs[case]
    np.testing.assert_array_equal(
        _per_key_payloads(*_global(got)), _per_key_payloads(*_global(ref))
    )
    gv = _global(got)[2]
    assert len(np.unique(gv)) == gv.shape[0], "payload not bijective"


@pytest.mark.parametrize("case", CASES)
def test_lost_and_valid_counts_equal_eager(runs, case):
    ref, got = runs[case]
    lost, n_valid = _eager(case, N_DEV)
    np.testing.assert_array_equal(got["lost"].reshape(-1), lost)
    np.testing.assert_array_equal(got["n_valid"].reshape(-1), n_valid)
    np.testing.assert_array_equal(got["lost"].reshape(-1),
                                  ref["lost"].reshape(-1))
    # the decorrelation shuffle, not slack capacity, keeps lost at zero
    assert (lost.sum() > 0) == (case == "spike_noshuffle")


def test_sentinel_words_keys_survive(runs):
    """Real keys whose words are SENTINEL's, as the padding's are, sort
    into the valid prefix at 8 ranks: every record in ``np.lexsort``
    order, every payload once, and ``n_valid`` the eager counts."""
    _, got = runs["sentinel_keys"]
    gh, gl, gv = _global(got)
    hi, lo, *_ = _inputs("sentinel_keys")
    o = np.lexsort((lo, hi))
    np.testing.assert_array_equal(gh, hi[o])
    np.testing.assert_array_equal(gl, lo[o])
    assert ((gh == SENTINEL) & (gl == SENTINEL)).sum() == 300
    np.testing.assert_array_equal(np.sort(gv), np.arange(hi.shape[0]))
    lost, n_valid = _eager("sentinel_keys", N_DEV)
    assert lost.sum() == 0
    np.testing.assert_array_equal(got["n_valid"].reshape(-1), n_valid)


@pytest.mark.parametrize("case", CASES)
def test_world_one_equals_reference_in_process(case):
    hi, lo, sample, n_leaf, shuffle = _inputs(case)
    n = hi.shape[0]
    jfn = jdist.make_sort_fn(
        jmesh(1), ("data",), _fit(jrmi, sample, n_leaf), n_per_device=n,
        capacity_factor=FACTOR, use_kernels=False, pre_shuffle=shuffle,
    )
    jout = jfn(jnp.asarray(hi), jnp.asarray(lo), jnp.arange(n, dtype=jnp.int32))
    mesh = tmesh.make_data_mesh(device="cpu")
    tfn = tdist.make_sort_fn(
        mesh, mesh.axis_names, _fit(trmi, sample, n_leaf), n,
        capacity_factor=FACTOR, pre_shuffle=shuffle,
    )
    tout = tfn(torch.from_numpy(hi.astype(np.int64)),
               torch.from_numpy(lo.astype(np.int64)),
               torch.arange(n, dtype=torch.int32))
    for j, t in zip(jout[:2], tout[:2]):  # padded outputs, word for word
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    assert int(tout[3][0]) == int(np.asarray(jout[3])[0]) == n
    assert int(tout[4][0]) == int(np.asarray(jout[4])[0]) == 0
    got = tdist.global_sorted_from_shards(*tout[:4], 1)
    want = jdist.global_sorted_from_shards(*jout[:4], 1)
    np.testing.assert_array_equal(_per_key_payloads(*got),
                                  _per_key_payloads(*want))
    assert (got[0] != SENTINEL).all()


def test_global_sorted_from_shards_takes_a_list_of_ranks():
    """A list of the ranks' outputs compacts as the gathered arrays do."""
    rng = np.random.default_rng(4)
    shards = [np.sort(rng.integers(0, 100, 6)) for _ in range(3)]
    n_valid = np.array([4, 6, 0], dtype=np.int32)
    vals = [np.arange(6, dtype=np.int32) + 10 * d for d in range(3)]
    as_list = tdist.global_sorted_from_shards(
        [torch.from_numpy(s) for s in shards], shards, vals,
        [torch.tensor([v]) for v in n_valid], 3,
    )
    stacked = jdist.global_sorted_from_shards(
        np.concatenate(shards), np.concatenate(shards), np.concatenate(vals),
        n_valid, 3,
    )
    for a, b in zip(as_list, stacked):
        np.testing.assert_array_equal(a, b)
    assert as_list[0].shape == (10,)


def test_data_mesh_contract_in_one_process():
    """No process group: a 1-device mesh; only 1-D meshes are ported;
    ``initialize_multiprocess`` without arguments does nothing."""
    tmesh.initialize_multiprocess(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_data_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert mesh.shape["data"] == 1 and mesh.axis_names == ("data",)
    x = torch.arange(6)
    assert mesh.all_to_all(x) is x
    assert mesh.all_gather(x).shape == (1, 6)
    assert mesh.all_gather_ints([3, 4]).tolist() == [[3, 4]]
    with pytest.raises(ValueError, match="requested 2 devices"):
        tmesh.make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"needs 4 ranks, the process group has 1"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    named = tmesh.make_mesh((1,), ("rows",), device="cpu")
    assert named.shape == {"rows": 1}
    named.check_axes(("rows",))
    with pytest.raises(ValueError, match="do not name"):
        named.check_axes(("data",))


def test_data_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_data_mesh()
