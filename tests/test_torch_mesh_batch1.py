"""A batch of one on a mesh with a size-1 axis (``sharding/spmd.py``).

A mesh axis of size 1 holds the whole tensor on its one rank, as the
reference's ``NamedSharding`` does over such an axis, so
``spmd.batch_placements`` gives it ``Replicate()``: DTensor cannot view or
reshape a dim of size 1 that is ``Shard``ed, even over one rank, and a
batch of 1 on a ``(1, 4)`` ("data", "model") mesh used to raise "would
remove or reshape sharded dimension 0" in every arch family.

On four gloo CPU ranks, one smoke arch per family — qwen3-4b (dense),
mixtral-8x7b (MoE), jamba-v0.1-52b (Mamba hybrid), xlstm-350m
(recurrent) and whisper-medium (encoder-decoder, with seeded frames) — on
``(1, 4)`` at batch 1:

* serving: prefill plus 2 decode steps give the no-mesh logits within
  the serving tolerance (atol = rtol = 5e-2,
  ``tests/test_torch_lm_serve.py``; measured at most 3.1e-6);
* training: step-0 gradients (``train_loop.grads_of``), gathered whole,
  within ``GRAD_RTOL`` = 0.05 relative L2 of the no-mesh ones, leaf by
  leaf (measured at most 0.0052: the bf16 rounding of the gradients),
  floored at 1e-3 of the whole gradient's norm as
  ``tests/test_torch_train_grads.py`` floors it (an expert no token
  reaches has a zero gradient).

Both runs compute in f32 (``layers.COMPUTE_DTYPE``), so that they differ
by the layout alone.  In bf16 the mesh splits reductions over "model"
and rounds them in another order: jamba's 8 layers of Mamba and MoE
then drift 0.074 (logits) and 0.095 (``x_proj``'s gradient) from one
device at batch 1, and as far at batch 2 and on ``(2, 2)`` (0.105 and
0.158; 0.12), layouts that ran before; mixtral's router gradient 0.052.

qwen3-4b at batch 1 on ``(2, 2)`` and ``(4, 1)``, and at batch 2 on
``(1, 4)``, which ran before, give the same checks.  The layouts
themselves are held on a stand-in mesh: ``Replicate`` on every size-1
axis, ``Shard(0)`` on the batch axes wherever the batch divides them.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Partial, Replicate, Shard  # noqa: E402

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL = 5e-2
GRAD_RTOL = 0.05  # tests/test_torch_train_mesh.py's bound on step-0 gradients
GRAD_FLOOR = 1e-3

FAMILIES = ["qwen3-4b", "mixtral-8x7b", "jamba-v0.1-52b", "xlstm-350m", "whisper-medium"]
# (arch, mesh shape, batch): the failing layout for every family, and
# the layouts that ran before for the dense arch
CASES = ([(a, (1, 4), 1) for a in FAMILIES]
         + [("qwen3-4b", (2, 2), 1), ("qwen3-4b", (4, 1), 1), ("qwen3-4b", (1, 4), 2)])
PROMPT, STEPS, TRAIN_SEQ = 6, 2, 8

RANK = r"""
import json, os, torch
import numpy as np
from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.models import layers
from repro_torch.models.api import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.train import train_loop

# f32 activations: the mesh and no-mesh runs then differ by f32 rounding
# alone, not by bf16 roundings of reductions split over "model"
layers.COMPUTE_DTYPE = torch.float32
M.initialize_multiprocess("file://" + os.environ["STORE"], device="cpu", timeout_s=120)
cases = json.loads(os.environ["CASES"])
prompt, steps, seq = (int(os.environ[k]) for k in ("PROMPT", "STEPS", "TRAIN_SEQ"))
meshes = {}

def mesh_of(shape):
    if shape not in meshes:
        meshes[shape] = M.make_device_mesh(shape, ("data", "model"), device="cpu")
    return meshes[shape]

def inputs(cfg, batch, n):
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_raw, (batch, n), dtype=np.int32))}
    if cfg.frontend != "none":
        b["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32))
    return b

def on(mesh, params, batch):
    rules.set_active_mesh(mesh)
    spmd.distribute_params(params, mesh)
    return spmd.shard_batch(batch, mesh)

def serve(model, mesh, batch):
    full = inputs(model.cfg, batch, prompt + steps)
    outs = []
    for m in (None, mesh):
        params = model.init_params(0, device="cpu")
        b = {**full, "tokens": full["tokens"][:, :prompt]}
        if m is not None:
            b = on(m, params, b)
        logits = []
        try:
            with torch.no_grad(), spmd.maybe_sharded(m):
                last, cache = model.prefill(params, b, max_seq=prompt + steps)
                logits.append(spmd.full(last).float())
                for t in range(steps):
                    nxt = full["tokens"][:, prompt + t : prompt + t + 1]
                    if m is not None:
                        nxt = spmd.shard_batch({"t": nxt}, m)["t"]
                    logits.append(spmd.full(model.decode_logits(params, cache, nxt))[:, -1].float())
        finally:
            rules.set_active_mesh(None)
        outs.append(torch.stack(logits))
    want, got = outs
    diff = (got - want).abs()
    return {"max_abs": float(diff.max()),
            "ok": bool((diff <= TOL + TOL * want.abs()).all())}

def grads(model, mesh, batch):
    full = inputs(model.cfg, batch, seq)
    outs = []
    for m in (None, mesh):
        params = model.trainable(model.init_params(0, device="cpu"))
        b = dict(full)
        if m is not None:
            b = on(m, params, b)
        try:
            with spmd.maybe_sharded(m):
                _, _, g = train_loop.grads_of(model, params, b)
        finally:
            rules.set_active_mesh(None)
        outs.append({n: spmd.full(t).float() for n, t in g.items()})
    want, got = outs
    total = sum(float(t.square().sum()) for t in want.values()) ** 0.5
    return {n: float((got[n] - want[n]).norm()) / max(float(want[n].norm()), FLOOR * total)
            for n in want}

TOL, FLOOR = float(os.environ["TOL"]), float(os.environ["FLOOR"])
res = {}
for arch, shape, batch in cases:
    model = build_model(registry.get_config(arch, smoke=True))
    mesh = mesh_of(tuple(shape))
    key = f"{arch} {tuple(shape)} {batch}"
    for what, fn in (("serve", serve), ("grads", grads)):
        try:
            res[f"{key} {what}"] = fn(model, mesh, batch)
        except RuntimeError as e:
            res[f"{key} {what}"] = {"error": str(e)[:300]}
if int(os.environ["RANK"]) == 0:
    print("RESULT " + json.dumps(res))
M.exit_rank()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_batch1")
    outs = tmesh.spawn(RANK, 4, timeout_s=600, env={
        "PYTHONPATH": SRC, "STORE": str(d / "store"), "OMP_NUM_THREADS": "1",
        "CASES": json.dumps(CASES), "PROMPT": str(PROMPT), "STEPS": str(STEPS),
        "TRAIN_SEQ": str(TRAIN_SEQ), "TOL": str(TOL), "FLOOR": str(GRAD_FLOOR)})
    line = [s for s in outs[0].splitlines() if s.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _key(arch, shape, batch, what):
    return f"{arch} {shape} {batch} {what}"


@pytest.mark.parametrize("arch,shape,batch", CASES)
def test_served_logits_match_one_device(runs, arch, shape, batch):
    res = runs[_key(arch, shape, batch, "serve")]
    assert "error" not in res, res
    assert res["ok"], res


@pytest.mark.parametrize("arch,shape,batch", CASES)
def test_step0_grads_match_one_device(runs, arch, shape, batch):
    err = runs[_key(arch, shape, batch, "grads")]
    assert "error" not in err, err
    assert max(err.values()) < GRAD_RTOL, sorted(err.items(), key=lambda e: -e[1])[:5]


class _Mesh:
    """A stand-in ``DeviceMesh``: its axis names and sizes alone."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("shape,names,batch,want", [
    ((1, 4), ("data", "model"), 1, ("R", "R")),
    ((1, 4), ("data", "model"), 2, ("R", "R")),
    ((1, 1), ("data", "model"), 2, ("R", "R")),
    ((2, 2), ("data", "model"), 2, ("S", "R")),
    ((2, 2), ("data", "model"), 1, ("R", "R")),
    ((4, 1), ("data", "model"), 4, ("S", "R")),
    ((4, 1), ("data", "model"), 2, ("R", "R")),
    ((2, 1, 4), ("pod", "data", "model"), 2, ("S", "R", "R")),
    ((2, 2, 4), ("pod", "data", "model"), 4, ("S", "S", "R")),
])
def test_batch_placements_replicate_size1_axes(shape, names, batch, want):
    got = spmd.batch_placements(_Mesh(shape, names), batch)
    kinds = tuple("S" if p == Shard(0) else "R" if p == Replicate() else str(p) for p in got)
    assert kinds == want
    assert spmd._summed_over_batch(got) == tuple(
        Partial() if k == "S" else Replicate() for k in want)
