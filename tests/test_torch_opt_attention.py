"""Opt-mode attention (``REPRO_OPT_SHARDING=1``) in the port.

* On a fake (1, 4) ("data", "model") mesh with smoke qwen3-4b's heads (H
  4, K 2: K does not divide "model"), each rank computes its own query
  heads with the kv heads they read: the per-device attention FLOPs that
  ``cost_analysis`` counts are 1/4 of the global count, in the dense
  product, the blockwise one (S 4,096) and decode over a cache, and over
  the whole smoke prefill (its ``bmm``s are the attention products) at
  64 and 2,100 tokens.  Outside opt mode every rank computes every head
  there, as before.
* The same split computed for real on four gloo CPU ranks over (1, 4):
  smoke qwen3-4b's prefill (24 tokens: the dense product; 2,100: the
  blockwise one) and decode steps give the no-mesh logits within the
  serving tolerance (atol = rtol = 5e-2, ``tests/test_torch_lm_serve.py``),
  and step-0 gradients (``train_loop.grads_of``, 16 tokens: the dense
  product; 2,100: the blockwise one) within ``GRAD_RTOL`` relative L2
  of the no-mesh ones, leaf by leaf (measured at most 0.024 and 0.017;
  with the kv gradients left unsummed over "model", 0.88 and 1.01, at
  ``k_norm`` and ``wv``).
* Opt-mode ``_blockwise`` (the reference's 1024 x 2048 blocks, bf16
  probabilities, f32 m and l) against the reference's ``_sdpa_chunked``
  in opt mode, op by op, at S = 4,096 on 16-wide heads, f32 inputs:
  within ``TOL_F32`` = 2^-13 (|out| < 2.4; measured at most 2^-14.1: a
  probability whose f32 value the two compute a little apart may round
  to another bf16), while the port outside opt mode (f32 probabilities)
  is 2^-12.0 to 2^-9.1 from it, outside ``TOL_F32``: the test fails
  without the opt-mode branch.
* ``_own_kv_heads`` picks the heads query head j reads, j // n_rep, on
  every rank of the production splits and of an uneven one.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL_F32 = 2.0**-13
GRAD_RTOL = 0.05  # tests/test_torch_train_mesh.py's bound on step-0 gradients

_FLOPS = textwrap.dedent("""
    import json, sys, torch
    from torch.distributed.tensor import distribute_tensor, Replicate
    from repro_torch.configs import registry
    from repro_torch.launch import cost_analysis, mesh as M
    from repro_torch.models import attention
    from repro_torch.models.api import build_model
    from repro_torch.sharding import rules, spmd
    M.init_fake_process_group(4)
    mesh = M.make_device_mesh((1, 4), ("data", "model"), device="cpu")
    cfg = registry.get_config("qwen3-4b", smoke=True)
    h, kv, hd, b = cfg.n_heads, cfg.n_kv, cfg.d_head, 2

    def qkv(sq, sk, dt):
        return [torch.empty((b, s, n, hd), device="meta", dtype=dt)
                for s, n in ((sq, h), (sk, kv), (sk, kv))]

    def products(sharded):
        out = {}
        for name, sq, sk in (("dense", 64, 64), ("blockwise", 4096, 4096), ("decode", 1, 64)):
            q, k, v = qkv(sq, sk, torch.bfloat16)
            if sharded:
                q, k, v = (distribute_tensor(t, mesh, [Replicate(), Replicate()]) for t in (q, k, v))
            if name == "blockwise":
                fn = lambda a, c, d: attention._sdpa_chunked(a, c, d, h // kv)
            else:
                mask = torch.ones((1, sq, sk), dtype=torch.bool, device="meta")
                fn = lambda a, c, d, m=mask: attention._sdpa(a, c, d, m, h // kv)
            with spmd.maybe_sharded(mesh if sharded else None):
                out[name] = cost_analysis.analyze(fn, q, k, v, fake=False).dot_flops
        return out

    def prefill(sharded, s):
        model = build_model(cfg)
        params = model.empty_params("meta")
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device="meta")}
        if sharded:
            rules.set_active_mesh(mesh)
            spmd.distribute_params(params, mesh)
            batch = spmd.shard_batch(batch, mesh)
        mode = cost_analysis.CostMode()
        try:
            with torch.no_grad(), mode, spmd.maybe_sharded(mesh if sharded else None):
                model.prefill(params, batch)
        finally:
            rules.set_active_mesh(None)
        return mode.cost.by_op[("bmm", "default")][1]

    res = {"sharded": products(True), "global": products(False)}
    for s in (64, 2100):
        res[f"prefill_{s}"] = [prefill(True, s), prefill(False, s)]
    print("RESULT " + json.dumps(res))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The counts with and without opt mode, each in a process of its
    own (the fake process group is global to its process), and the four
    ranks' run, all at once."""
    from repro_torch.launch import mesh as tmesh

    procs = {}
    for opt in ("1", "0"):
        env = {**os.environ, "REPRO_OPT_SHARDING": opt,
               "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
        procs[opt] = subprocess.Popen([sys.executable, "-c", _FLOPS], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        d = tmp_path_factory.mktemp("opt_ranks")
        ranks = tmesh.spawn(_RANKS, 4, timeout_s=600, env={
            "PYTHONPATH": SRC, "STORE": str(d / "store"), "REPRO_OPT_SHARDING": "1",
            "OMP_NUM_THREADS": "1"})
        line = [s for s in ranks[0].splitlines() if s.startswith("RESULT ")][-1]
        out["ranks"] = json.loads(line[len("RESULT "):])
        for opt, p in procs.items():
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, se[-4000:]
            line = [s for s in so.splitlines() if s.startswith("RESULT ")][-1]
            out[opt] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("path", ["dense", "blockwise", "decode"])
def test_opt_products_split_heads_over_model(runs, path):
    res = runs["1"]
    assert res["global"][path] > 0
    assert res["sharded"][path] * 4 == res["global"][path]


@pytest.mark.parametrize("s", [64, 2100])
def test_opt_prefill_attention_flops_are_a_quarter(runs, s):
    sharded, whole = runs["1"][f"prefill_{s}"]
    assert whole > 0 and sharded * 4 == whole


def test_without_opt_every_rank_computes_every_head(runs):
    res = runs["0"]
    assert res["sharded"] == res["global"]
    sharded, whole = res["prefill_64"]
    assert sharded == whole


@pytest.mark.parametrize("h,kv,m", [(32, 8, 16), (64, 8, 16), (48, 8, 16), (4, 2, 4),
                                    (24, 4, 6), (8, 8, 4)])
def test_own_kv_heads_are_the_ones_each_query_head_reads(h, kv, m):
    n_rep = h // kv
    k = torch.arange(kv, dtype=torch.float32).reshape(1, 1, kv, 1)
    hl = h // m
    for r in range(m):
        kk, vv, nr = spmd._own_kv_heads(k, k, hl, r, n_rep)
        read = kk[0, 0, :, 0].repeat_interleave(nr)
        assert read.tolist() == [(r * hl + j) // n_rep for j in range(hl)]


_RANKS = textwrap.dedent("""
    import json, os, torch
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as M
    from repro_torch.models.api import build_model
    from repro_torch.sharding import rules, spmd
    from repro_torch.train import train_loop

    M.initialize_multiprocess("file://" + os.environ["STORE"], device="cpu", timeout_s=120)
    mesh = M.make_device_mesh((1, 4), ("data", "model"), device="cpu")
    assert rules.opt_sharding_enabled()
    cfg = registry.get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)

    def run(batch, prompt, steps):
        g = torch.Generator().manual_seed(0)
        tok = torch.randint(0, cfg.vocab_raw, (batch, prompt + steps), generator=g,
                            dtype=torch.int32)
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
                last, cache = model.prefill(params, b, max_seq=prompt + steps)
                logits.append(spmd.full(last))
                for t in range(steps):
                    nxt = tok[:, prompt + t : prompt + t + 1]
                    if sharded:
                        nxt = spmd.shard_batch({"t": nxt}, mesh)["t"]
                    logits.append(spmd.full(model.decode_logits(params, cache, nxt))[:, -1])
            rules.set_active_mesh(None)
            outs.append(torch.stack(logits))
        diff = (outs[0] - outs[1]).abs()
        return {"max_abs": float(diff.max()),
                "ok": bool((diff <= 5e-2 + 5e-2 * outs[0].abs()).all())}

    def grad_errors(batch, seq):
        # each leaf's relative L2 gap between the step-0 gradients on the
        # mesh (gathered whole) and without one
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_raw, (batch, seq), generator=g, dtype=torch.int32)
        outs = []
        for sharded in (False, True):
            params = model.trainable(model.init_params(0, device="cpu"))
            b = {"tokens": tok}
            if sharded:
                rules.set_active_mesh(mesh)
                spmd.distribute_params(params, mesh)
                b = spmd.shard_batch(b, mesh)
            with spmd.maybe_sharded(mesh if sharded else None):
                _, _, grads = train_loop.grads_of(model, params, b)
            rules.set_active_mesh(None)
            outs.append({n: spmd.full(t).float() for n, t in grads.items()})
        want, got = outs
        return {n: float((got[n] - want[n]).norm() / want[n].norm()) for n in want}

    res = {"dense": run(2, 24, 4), "blockwise": run(2, 2100, 2),
           "grads_dense": grad_errors(2, 16), "grads_blockwise": grad_errors(2, 2100)}
    if int(os.environ["RANK"]) == 0:
        print("RESULT " + json.dumps(res))
    M.exit_rank()
""")


@pytest.mark.parametrize("path", ["dense", "blockwise"])
def test_kv_heads_split_on_four_ranks_match_one_device(runs, path):
    res = runs["ranks"][path]
    assert res["ok"], res


@pytest.mark.parametrize("path", ["dense", "blockwise"])
def test_kv_heads_split_on_four_ranks_give_the_one_device_gradients(runs, path):
    err = runs["ranks"][f"grads_{path}"]
    assert max(err.values()) < GRAD_RTOL, sorted(err.items(), key=lambda e: -e[1])[:5]


def _inputs(s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, n, hd)).astype(np.float32) for n in (h, kv, kv)]


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 1024)])
def test_opt_blockwise_matches_reference_opt_mode(monkeypatch, causal, window):
    monkeypatch.setenv("REPRO_OPT_SHARDING", "1")
    h, kv, hd = 4, 2, 16
    q, k, v = _inputs(4096, h, kv, hd)
    with jax.disable_jit():
        want = jattn._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                   h // kv, causal=causal, window=window)
    want = np.asarray(want)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    got = attention._sdpa_chunked(*ts, h // kv, causal=causal, window=window)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL_F32, err
    monkeypatch.delenv("REPRO_OPT_SHARDING")
    plain = attention._sdpa_chunked(*ts, h // kv, causal=causal, window=window)
    gap = np.abs(plain.numpy() - want).max()
    assert gap > TOL_F32, gap
