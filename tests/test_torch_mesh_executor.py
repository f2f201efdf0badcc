"""Port parity of the mesh executor: ``repro_torch.core.executor.
MeshBatchedExecutor`` on a 1-device mesh (a process without a process
group, on the CPU) against ``repro.core.executor.MeshBatchedExecutor``
on a 1-device jax mesh: the permutation of every group dispatch, the
sorted blocks (gensort records and line records, whose keys run past the
8 encoded bytes, so the memcmp touch-up matters), and the dispatch
accounting (dispatches, slots, records, shapes).  Then the lockstep of
two gloo ranks that hold different numbers of groups.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jex  # noqa: E402
from repro.core import rmi as jrmi  # noqa: E402
from repro.core.format import GENSORT as JGENSORT  # noqa: E402
from repro.core.format import LineFormat as JLineFormat  # noqa: E402
from repro.launch.mesh import make_data_mesh as jmesh  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import rmi as trmi  # noqa: E402
from repro_torch.core.config import ExecutorConfig  # noqa: E402
from repro_torch.core.format import GENSORT, LineFormat  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
COUNTERS = ("dispatches", "batch_slots", "batch_records", "jit_compiles",
            "occupancy", "fallbacks")


def _model():
    return jrmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=256)


def _fixed_parts(sizes, seed=0, dup=False):
    recs = gensort.make_records(sum(sizes), seed=seed)
    if dup:  # a few distinct keys: ties everywhere
        vocab = gensort.uniform_keys(5, seed=seed + 1)
        recs[:, : gensort.KEY_BYTES] = vocab[
            np.random.default_rng(seed).integers(0, 5, sum(sizes))
        ]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [recs[a:b].tobytes() for a, b in zip(bounds[:-1], bounds[1:])]


def _line_parts(sizes, seed=0):
    """Lines sharing an 8-byte prefix, so order is decided past it."""
    rng = np.random.default_rng(seed)
    parts = []
    for m in sizes:
        body = rng.integers(97, 100, (m, 6), dtype=np.uint8)
        parts.append(b"".join(b"prefix__" + bytes(r) + b"\n" for r in body))
    return parts


def _executors(**kw):
    model = _model()
    jx = jex.MeshBatchedExecutor(model, mesh=jmesh(1), **kw)
    tx = tex.MeshBatchedExecutor(
        trmi.params_from_numpy(model),
        mesh=tmesh.make_data_mesh(device="cpu"), **kw,
    )
    return jx, tx


def _run(ex, fmt, parts):
    got = dict(ex.sort_iter((i, fmt.parse_blob(b)) for i, b in enumerate(parts)))
    return [got[i].tobytes() for i in range(len(parts))]


CASES = {
    "tiny": ([1, 2, 3], {}),
    "edges": ([100, 1023, 1024, 1025, 7], {}),
    "many_segments": ([400] * 40, {}),
    "slot_cap": ([int(s) for s in np.random.default_rng(7).integers(2, 3000, 30)],
                 {"batch_slots": 4096}),
    "byte_cap": ([1500, 1500, 1500], {"batch_bytes": 200_000}),
    "segment_cap": ([50] * 9, {"max_segments": 4}),
}


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_executor_equals_jax_fixed(case, dup):
    sizes, kw = CASES[case]
    parts = _fixed_parts(sizes, seed=len(sizes), dup=dup)
    jx, tx = _executors(**kw)
    assert _run(tx, GENSORT, parts) == _run(jx, JGENSORT, parts)
    for attr in COUNTERS:
        assert getattr(tx, attr) == getattr(jx, attr), attr
    assert tx.compile_keys == jx.compile_keys


def test_mesh_executor_equals_jax_lines():
    parts = _line_parts([300, 1, 700, 2], seed=3)
    jx, tx = _executors()
    got = _run(tx, LineFormat(max_key_bytes=16), parts)
    assert got == _run(jx, JLineFormat(max_key_bytes=16), parts)
    assert got[0] == b"".join(sorted(parts[0].splitlines(keepends=True)))
    for attr in COUNTERS:
        assert getattr(tx, attr) == getattr(jx, attr), attr


@pytest.mark.parametrize("sizes", [[700, 300, 5], [2000], [64] * 12])
def test_mesh_dispatch_permutation_equals_jax(sizes):
    """One group dispatch: the port's permutation is the reference's
    device permutation, pad rows included."""
    parts = _fixed_parts(sizes, seed=5, dup=True)
    jx, tx = _executors()
    entries_j = [(i, JGENSORT.parse_blob(b)) for i, b in enumerate(parts)]
    entries_t = [(i, GENSORT.parse_blob(b)) for i, b in enumerate(parts)]
    _, perm_j = jx._dispatch(entries_j)
    assert tx._agree(entries_t)
    _, n_pad, slot, _ = tx._dispatch(entries_t)
    perm_t, _ = slot.result(n_pad)
    np.testing.assert_array_equal(perm_t, np.asarray(perm_j)[0])
    assert tx.compile_keys == jx.compile_keys


def test_make_executor_builds_the_mesh_executor():
    model = trmi.params_from_numpy(_model())
    ex = tex.make_executor(model, device="cpu", executor="mesh")
    assert isinstance(ex, tex.MeshBatchedExecutor) and ex.collective
    assert ex.mesh.world_size == 1 and ex.device.type == "cpu"
    mesh = tmesh.make_data_mesh(device="cpu")
    ex = tex.make_executor(
        model, ExecutorConfig(executor="mesh", mesh=mesh, device="cpu",
                              max_segments=4),
    )
    assert ex.mesh is mesh and ex.max_segments == 4
    assert tex.make_executor(model, executor="mesh", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh on cpu"):
        tex.make_executor(model, executor="mesh", mesh=mesh, device="cuda")


LOCKSTEP = r"""
import json, os
import numpy as np
from repro_torch.core import executor, rmi
from repro_torch.core.format import GENSORT
from repro_torch.data import gensort
from repro_torch.launch import mesh as M

M.initialize_multiprocess("file://" + os.environ["STORE"],
                          int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), device="cpu", timeout_s=60)
mesh = M.make_data_mesh(device="cpu")
model = rmi.fit(gensort.uniform_keys(4096, seed=0), n_leaf=256)
ex = executor.MeshBatchedExecutor(model, mesh=mesh, max_segments=2)
# rank 0: five blocks (three groups of <= 2) and a 1-record block that
# is never dispatched; rank 1: one block (one group)
sizes = [300, 200, 100, 50, 25, 1] if mesh.rank == 0 else [400]
recs = gensort.make_records(sum(sizes), seed=mesh.rank)
bounds = np.concatenate([[0], np.cumsum(sizes)])
blocks = [(i, GENSORT.parse_blob(recs[a:b].tobytes()))
          for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))]
out = dict(ex.sort_iter(iter(blocks)))
ok = all(
    out[i].tobytes() == b"".join(sorted(
        bytes(r) for r in recs[a:b]))
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
)
print("RES " + json.dumps({"ok": ok, "n": len(out), "dispatches": ex.dispatches,
                           "slots": ex.batch_slots, "records": ex.batch_records,
                           "shapes": sorted(k[2] for k in ex.compile_keys)}))
M.exit_rank()
"""


def test_two_ranks_dispatch_in_lockstep(tmp_path):
    """Rank 0 has three groups, rank 1 one: rank 1 joins the rounds with an
    empty shard, both count the same three group dispatches (slots of
    both ranks, records of both), and both sort their blocks."""
    outs = tmesh.spawn(LOCKSTEP, 2, timeout_s=120, env={
        "STORE": str(tmp_path / "store"), "PYTHONPATH": SRC,
    })
    res = [json.loads(next(x[4:] for x in o.splitlines() if x.startswith("RES ")))
           for o in outs]
    assert res[0]["ok"] and res[1]["ok"]
    assert (res[0]["n"], res[1]["n"]) == (6, 1)
    for k in ("dispatches", "slots", "records", "shapes"):
        assert res[0][k] == res[1][k], k
    assert res[0]["dispatches"] == 3
    assert res[0]["records"] == 300 + 200 + 100 + 50 + 25 + 400
    # group widths: max(500, 400), max(150, 0), max(25, 0), padded
    assert res[0]["shapes"] == [32, 160, 512]
    assert res[0]["slots"] == 2 * (512 + 160 + 32)
