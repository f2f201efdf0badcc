"""The port's cost analysis (``repro_torch.launch.cost_analysis``) against
the reference's HLO analysis (``repro.launch.hlo_analysis``).

The four functions of ``tests/test_hlo_analysis.py`` written in torch
(the reference's ``lax.scan`` a Python loop) give the reference's
``dot_flops`` exactly; the gradient with a checkpoint per layer falls in
the same 3-4.5x band.  The smoke qwen3-4b train step, prefill and decode
step are within 5 % of the reference's analysis of its compiled step
(measured: the same count exactly, 94,371,840 / 23,101,440 / 393,216).
Per-device counts come from below DTensor's dispatch: a matmul sharded
over a fake 4 x 4 mesh counts its local shard's FLOPs and the
collectives DTensor issues.
"""

import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt, train_loop as jloop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import optimizer as opt_lib, train_loop  # noqa: E402

PER_LAYER = 2 * 8 * 128 * 128
W = torch.zeros(16, 128, 128)
X = torch.zeros(8, 128)


def _body(x, w):
    return torch.tanh(x @ w)


def _scan_fn(x, ws):
    for i in range(16):
        x = _body(x, ws[i])
    return x


def test_scan_flops_exact():
    assert cost_analysis.analyze(_scan_fn, X, W).dot_flops == 16 * PER_LAYER


def test_nested_scan_flops_exact():
    def nested(x, ws):
        for _ in range(3):
            x = _scan_fn(x, ws)
        return x

    assert cost_analysis.analyze(nested, X, W).dot_flops == 3 * 16 * PER_LAYER


def test_unrolled_matches_scan():
    def unroll(x, ws):
        for w in ws.unbind(0):
            x = _body(x, w)
        return x

    assert (cost_analysis.analyze(unroll, X, W).dot_flops
            == cost_analysis.analyze(_scan_fn, X, W).dot_flops)


def test_grad_flops_in_expected_band():
    def grads(ws, x):
        ws = ws.clone().requires_grad_(True)
        y = x
        for i in range(16):
            y = checkpoint(_body, y, ws[i], use_reentrant=False)
        return torch.autograd.grad((y**2).mean(), ws)

    cost = cost_analysis.analyze(grads, W, X)
    fwd = 16 * PER_LAYER
    assert 3.0 * fwd <= cost.dot_flops <= 4.5 * fwd, cost.dot_flops / fwd


def test_bytes_positive_and_bounded_and_breakdown():
    cost = cost_analysis.analyze(_scan_fn, X, W)
    assert 16 * 128 * 128 * 4 < cost.hbm_bytes < 1e9
    rows = cost.breakdown(3)
    assert rows[0][2] >= rows[-1][2] and ("mm", "default") in {r[:2] for r in cost.breakdown()}
    assert set(cost.as_dict()) == set(hlo_analysis.HloCost().as_dict())


def test_nothing_is_computed_or_allocated():
    """A 2^16 x 2^16 f32 product (16 GiB an operand) on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        big = torch.empty((1 << 16, 1 << 16))

    cost = cost_analysis.analyze(lambda a: a @ a, big)
    assert cost.dot_flops == 2.0 * (1 << 16) ** 3
    assert cost.hbm_bytes == 3 * (1 << 32) * 4


B, S = 2, 64


def _ref_flops(kind):
    jm = jbuild(jreg.get_config("qwen3-4b", smoke=True))
    p = jm.params_spec()
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        step = jloop.build_train_step(jm, jopt.AdamWConfig())
        o = jax.eval_shape(jopt.init_state, p)
        lowered = jax.jit(step).lower(p, o, {"tokens": tok})
    elif kind == "prefill":
        lowered = jax.jit(lambda pp, b: jm.prefill(pp, b)).lower(p, {"tokens": tok})
    else:
        c = jax.eval_shape(lambda: jm.init_cache(B, S))
        lowered = jax.jit(jloop.build_serve_step(jm)).lower(
            p, c, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    return hlo_analysis.analyze(lowered.compile().as_text()).dot_flops


def _port_flops(kind):
    m = build_model(registry.get_config("qwen3-4b", smoke=True))
    params = m.init_params(0, device="cpu")
    tokens = torch.zeros((B, S), dtype=torch.int32)
    if kind == "train":
        m.trainable(params)
        step = train_loop.build_train_step(m, opt_lib.AdamWConfig())
        state = opt_lib.init_state(params)
        return cost_analysis.analyze(step, params, state, {"tokens": tokens}).dot_flops
    # under no_grad: inference_mode (build_prefill, build_serve_step)
    # dispatches past Python modes on fake tensors
    if kind == "prefill":
        fn = torch.no_grad()(m.prefill)
        return cost_analysis.analyze(fn, params, {"tokens": tokens}).dot_flops
    cache = m.init_cache(B, S, device="cpu")
    fn = torch.no_grad()(m.decode_step)
    return cost_analysis.analyze(fn, params, cache, tokens[:, :1]).dot_flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_step_flops_match_reference(kind):
    ref, got = _ref_flops(kind), _port_flops(kind)
    assert abs(got / ref - 1) < 0.05, (got, ref, got / ref)


# a fresh process: the fake process group is global to its process
_SHARDED = textwrap.dedent("""
    import json, torch
    from torch.utils.flop_counter import FlopCounterMode
    from torch.distributed.tensor import distribute_tensor, Shard, Replicate
    from repro_torch.launch import cost_analysis, mesh as tmesh
    tmesh.init_fake_process_group(16)
    mesh = tmesh.make_device_mesh((4, 4), ("data", "model"), device="cpu")
    with torch._subclasses.fake_tensor.FakeTensorMode():
        x = distribute_tensor(torch.empty(32, 2560), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(2560, 9728), mesh, [Shard(0), Shard(1)])
        cost = cost_analysis.analyze(lambda a, b: a @ b, x, w, fake=False)
        flop = FlopCounterMode(display=False)
        with flop:
            x @ w
    print(json.dumps({"cost": cost.as_dict(), "global": flop.get_total_flops()}))
""")


def test_per_device_flops_come_from_the_local_shards():
    """32 x 2560 @ 2560 x 9728 over a fake 4 x 4 mesh, x batch-sharded and
    w sharded (data, model): DTensor gathers x (one all-gather over
    "data") and each rank multiplies x's 640-deep slice by its block of
    w, a partial sum over "data" — 1/16 of the global FLOPs that
    ``FlopCounterMode`` reports at the global shape."""
    import json
    import os

    env = {**os.environ, "PYTHONPATH": "src" + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", _SHARDED], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    glob = 2 * 32 * 2560 * 9728
    assert res["global"] == glob
    assert res["cost"]["dot_flops"] == glob / 16
    ag = res["cost"]["collectives"]["all-gather"]
    assert ag == {"count": 1.0, "result_bytes": 32 * 2560 * 4, "max_group": 4}
