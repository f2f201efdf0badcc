"""The sharded LM step on four gloo CPU ranks (``repro_torch.launch.train``
with a ``mesh_shape``; ``sharding/spmd.py``), held to the reference's
single-device ``launch.train.train`` from the same numpy parameters.
(The rank script and its helpers are shared with
``tests/test_torch_train_mesh_moe.py``.)

qwen3-4b's smoke config trains 8 steps on 4 x 16 ``SyntheticLM`` tokens
on each of the ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` ("data", "model")
meshes; every step's loss is within the tolerance
``tests/test_torch_train_loop.py`` holds the single-device launcher to
(``rtol=2e-2``; measured within 1e-3).  Step 0's gradients, gathered
whole, are within ``GRAD_RTOL`` = 0.05 relative L2 of ``jax.grad`` of
the reference's loss, leaf by leaf (measured at most 0.031, on
``(1, 4)``): a layout fault that drops the reduction over "data" leaves
the losses within 6e-3 but the embedding's gradient 0.72 and 0.87 off
on ``(2, 2)`` and ``(4, 1)``.  A run stopped after step 4 on
``(2, 2)`` resumes from its checkpoint on ``(4, 1)`` and on one rank
(no process group), replaying the uninterrupted losses within 2e-2;
each rank's restored leaf holds its own shard alone.
The MoE arch runs in ``tests/test_torch_train_mesh_moe.py``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.launch import mesh as tmesh, train as ttrain  # noqa: E402
from repro_torch.models import api, convert  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
ARCH = "qwen3-4b"
MESHES = [(2, 2), (4, 1), (1, 4)]
KW = dict(smoke=True, batch=4, seq=16, log_every=100, device="cpu")
GRAD_RTOL = 0.05

RANK = r"""
import json, os, torch
from repro_torch.launch import mesh as M, train as T
from repro_torch.models import api
from repro_torch.sharding import spmd
from repro_torch.train import checkpoint as C, optimizer as O
sd = torch.load(os.environ["SD"])
api.Model.init_params = lambda self, seed=0, device="cuda": self.load_params(sd, device)
M.initialize_multiprocess("file://" + os.environ["STORE"], device="cpu", timeout_s=120)
rank = int(os.environ["RANK"])
arch, ck, d = os.environ["ARCH"], os.environ["CKPT"], os.environ["OUT"]
kw = dict(smoke=True, batch=4, seq=16, log_every=100, device="cpu")
out, first, apply = {}, {}, O.apply_updates

def record(cfg, params, grads, state):  # the gradients of each run's step 0, whole
    if not first:
        first.update({n: spmd.full(g).float() for n, g in grads.items()})
    return apply(cfg, params, grads, state)

O.apply_updates = record
for shape in json.loads(os.environ["MESHES"]):
    first.clear()
    out[str(tuple(shape))] = T.train(arch, steps=8, mesh_shape=tuple(shape), **kw)
    if rank == 0:
        torch.save(first, os.path.join(d, "grads_%dx%d.pt" % tuple(shape)))
if ck:
    T.train(arch, steps=4, mesh_shape=(2, 2), ckpt_dir=ck, ckpt_every=4, **kw)
    out["resumed (4, 1)"] = T.train(arch, steps=8, mesh_shape=(4, 1), ckpt_dir=ck,
                                    ckpt_every=100, **kw)
    # a restored leaf split over "data" holds this rank's rows alone
    w = spmd.distribute(torch.arange(64.0).reshape(16, 4),
                        M.make_device_mesh((2, 2), ("data", "model"), device="cpu"),
                        ("data", None))
    C.save(os.path.join(d, "leaf"), 1, {"w": w})
    back = C.restore(os.path.join(d, "leaf"), 1, {"w": w})["w"]
    loc = back.to_local()
    out["restored shard"] = {
        "equal": bool(torch.equal(loc, w.to_local())), "placements": str(back.placements),
        "storage_bytes": loc.untyped_storage().nbytes(), "shard_bytes": loc.numel() * 4}
if rank == 0:
    print("RESULT " + json.dumps(out))
M.exit_rank()
"""


def reference_params(arch):
    """The reference's ``jax.random.key(0)`` parameters, converted."""
    jparams = jbuild(jreg.get_config(arch, smoke=True)).init_params(jax.random.key(0))
    return convert.from_jax_params(jax.device_get(jparams))


def reference_grads(arch):
    """The reference's step-0 gradients (bf16, as its train step rounds
    them) of the ``jax.random.key(0)`` parameters on ``SyntheticLM``'s
    batch 0 of 4 x 16, converted to the port's leaf names."""
    jmodel = jbuild(jreg.get_config(arch, smoke=True))
    jparams = jmodel.init_params(jax.random.key(0))
    batch = jpipe.SyntheticLM(jpipe.PipelineConfig(
        vocab=jmodel.cfg.vocab_raw, seq_len=16, global_batch=4)).batch_at(0)
    grads = jax.grad(lambda p: jmodel.loss_fn(p, batch)[0])(jparams)
    grads = jax.tree.map(lambda g: g.astype(jnp.bfloat16), grads)
    return {n: g.float() for n, g in convert.from_jax_params(jax.device_get(grads)).items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's relative L2 error, ``|got - want| / |want|``."""
    assert set(got) == set(want)
    return {n: float((got[n] - want[n]).norm() / want[n].norm()) for n in want}


def run_ranks(arch, d, *, ckpt: str = "") -> dict:
    """Four gloo ranks training ``arch`` on every mesh of ``MESHES`` (and,
    with ``ckpt``, the stop-and-resume runs); rank 0's losses."""
    sd_path = str(d / "sd.pt")
    torch.save(reference_params(arch), sd_path)
    outs = tmesh.spawn(RANK, 4, timeout_s=900, env={
        "PYTHONPATH": SRC, "SD": sd_path, "STORE": str(d / "store"), "ARCH": arch,
        "CKPT": ckpt, "OUT": str(d), "MESHES": json.dumps(MESHES)})
    line = [s for s in outs[0].splitlines() if s.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def sharded_grads(d, shape) -> dict:
    """Rank 0's record of the step-0 gradients on ``shape``, whole."""
    return torch.load(d / ("grads_%dx%d.pt" % shape))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    want = jtrain.train(ARCH, smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,),
                        log_every=100)
    return want, run_ranks(ARCH, d, ckpt=str(d / "ck")), d


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_losses_match_reference(runs, shape):
    want, got, _ = runs
    np.testing.assert_allclose(got[str(shape)], want, rtol=2e-2)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step0_grads_match_reference(runs, shape):
    _, _, d = runs
    err = grad_errors(sharded_grads(d, shape), reference_grads(ARCH))
    assert max(err.values()) < GRAD_RTOL, sorted(err.items(), key=lambda e: -e[1])[:5]


def test_checkpoint_restores_on_another_mesh(runs):
    _, got, _ = runs
    np.testing.assert_allclose(got["resumed (4, 1)"], got["(2, 2)"][4:], rtol=2e-2)


def test_restored_leaf_holds_its_shard_alone(runs):
    _, got, _ = runs
    r = got["restored shard"]
    assert r["equal"] and r["placements"] == "(Shard(dim=0), Replicate())", r
    assert r["storage_bytes"] == r["shard_bytes"] == 8 * 4 * 4, r


def test_checkpoint_restores_on_one_rank(runs, monkeypatch):
    _, got, d = runs
    sd = reference_params(ARCH)
    monkeypatch.setattr(api.Model, "init_params",
                        lambda self, seed=0, device="cuda": self.load_params(sd, device))
    resumed = ttrain.train(ARCH, steps=8, mesh_shape=(1,), ckpt_dir=str(d / "ck"),
                           ckpt_every=100, **KW)
    np.testing.assert_allclose(resumed, got["(2, 2)"][4:], rtol=2e-2)


def test_a_mesh_larger_than_the_world_is_refused():
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 2\) holds 4 ranks, the world size is 1"):
        ttrain.train(ARCH, steps=1, mesh_shape=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="one or two axes"):
        ttrain.train(ARCH, steps=1, mesh_shape=(1, 1, 1), device="cpu")
