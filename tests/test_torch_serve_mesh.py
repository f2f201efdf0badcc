"""The ``REPRO_OPT_SHARDING`` branches of the port's sharded serving path
on four gloo CPU ranks over a ``(2, 2)`` ("data", "model") mesh, held to
the no-mesh path's logits within the serving tolerance (atol = rtol =
5e-2, ``tests/test_torch_lm_serve.py``):

* qwen3-4b (smoke): the query-head constraint, and a decode cache whose
  sequence axis is sharded over "model" (the opt-mode decode layout) —
  batch 4, a 24-token prompt and 4 decode steps in a 32-slot cache;
* the same at batch 1: the cache sequence-sharded over ("data",
  "model"), written by the ``local_map`` with shard-local index
  arithmetic, one token at a time across shard boundaries;
* one MoE sublayer of mixtral's smoke config with 16 experts on 96
  tokens: the expert-parallel dispatch and combine constraints
  (``e % 16 == 0``), the same routes as the no-mesh path and its output
  within the tolerance.  (Through a whole model the sharded products'
  bf16 rounding moves router near-ties, so the MoE is held layer by
  layer, as ``tests/test_torch_lm_serve.py`` holds routes.)

Every rank computes both paths from the same parameters; rank 0 reports
the largest differences.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL = 5e-2

RANK = r"""
import dataclasses, json, os, torch
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as M
from repro_torch.models import layers, moe
from repro_torch.models.api import build_model
from repro_torch.sharding import rules, spmd

M.initialize_multiprocess("file://" + os.environ["STORE"], device="cpu", timeout_s=120)
mesh = M.make_device_mesh((2, 2), ("data", "model"), device="cpu")
assert rules.opt_sharding_enabled()

def run(cfg, batch, prompt, steps, max_seq):
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_raw, (batch, prompt + steps), generator=g, dtype=torch.int32)
    outs = []
    for sharded in (False, True):
        params = model.init_params(0, device="cpu")
        b = {"tokens": tok[:, :prompt]}
        if sharded:
            rules.set_active_mesh(mesh)
            spmd.distribute_params(params, mesh)
            b = spmd.shard_batch(b, mesh)
        logits = []
        with torch.no_grad(), spmd.maybe_sharded(mesh if sharded else None):
            last, cache = model.prefill(params, b, max_seq=max_seq)
            logits.append(spmd.full(last))
            if sharded:
                k = next(iter(cache.layers[0].values()))["k"]
                layout = [str(p) for p in k.placements]
            for t in range(steps):
                nxt = tok[:, prompt + t : prompt + t + 1]
                if sharded:
                    nxt = spmd.shard_batch({"t": nxt}, mesh)["t"]
                logits.append(spmd.full(model.decode_logits(params, cache, nxt))[:, -1])
        rules.set_active_mesh(None)
        outs.append(torch.stack(logits))
    diff = (outs[0] - outs[1]).abs()
    bound = 5e-2 + 5e-2 * outs[0].abs()
    return {"max_abs": float(diff.max()), "ok": bool((diff <= bound).all()),
            "cache_layout": layout}

def moe_layer(cfg):
    g = torch.Generator().manual_seed(0)
    p = moe.MoE(cfg, g, "cpu")
    x = torch.randn(4, 24, cfg.d_model, generator=g).to(torch.bfloat16)
    outs = []
    with torch.no_grad():
        for sharded in (False, True):
            xi = x
            if sharded:
                rules.set_active_mesh(mesh)
                # named as a model's layer ("layers.0.01_moe.w_gate"): the
                # rules read an unrolled layer's expert tensor as the
                # reference's stacked (L, E, D, F)
                holder = torch.nn.Module()
                holder.layers = torch.nn.ModuleList([torch.nn.ModuleDict({"01_moe": p})])
                spmd.distribute_params(holder, mesh)
                xi = spmd.shard_batch({"x": x}, mesh)["x"]
            with spmd.maybe_sharded(mesh if sharded else None):
                y, _ = moe.apply_moe(p, cfg, xi)
                xn = layers.rms_norm(xi, p.norm, cfg.norm_eps).reshape(-1, cfg.d_model)
                top_e = moe.route(p, cfg, xn)[3]
            rules.set_active_mesh(None)
            outs.append((spmd.full(y).float(), spmd.full(top_e)))
    (y0, e0), (y1, e1) = outs
    diff = (y0 - y1).abs()
    return {"max_abs": float(diff.max()), "ok": bool((diff <= 5e-2 + 5e-2 * y0.abs()).all()),
            "routes_differ": int((e0 != e1).any(-1).sum()),
            "expert_layout": [str(q) for q in p.w_gate.placements]}

qwen = registry.get_config("qwen3-4b", smoke=True)
mix = registry.get_config("mixtral-8x7b", smoke=True)
mix16 = dataclasses.replace(mix, moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=64))
res = {
    "batch4": run(qwen, 4, 24, 4, 32),
    "batch1": run(qwen, 1, 6, 4, 16),
    "moe16": moe_layer(mix16),
}
if int(os.environ["RANK"]) == 0:
    print("RESULT " + json.dumps(res))
M.exit_rank()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    outs = tmesh.spawn(RANK, 4, timeout_s=600, env={
        "PYTHONPATH": SRC, "STORE": str(d / "store"), "REPRO_OPT_SHARDING": "1"})
    line = [s for s in outs[0].splitlines() if s.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_head_constraint_and_model_sharded_decode_cache(runs):
    r = runs["batch4"]
    assert r["ok"], r
    assert r["cache_layout"] == ["S(0)", "S(1)"]


def test_sequence_sharded_cache_write(runs):
    r = runs["batch1"]
    assert r["ok"], r
    assert r["cache_layout"] == ["S(1)", "S(1)"]


def test_expert_parallel_dispatch(runs):
    r = runs["moe16"]
    assert r["ok"] and r["routes_differ"] == 0, r
    assert r["expert_layout"] == ["S(1)", "S(0)"]  # d_model over data, experts over model
