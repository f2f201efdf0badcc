"""Port parity of AdamW (``repro_torch.train.optimizer`` against
``repro.train.optimizer``): the schedule, ``apply_updates`` on identical
parameters and bf16 gradients (clip active and not), and the reference's
own checks (``tests/test_train_substrate.py``) on the port.

Tolerance: ``rtol=1e-6``.  The update is the reference's arithmetic op
for op, and measured bit-equal over three steps; the schedule's cosine
differs from XLA:CPU's by one f32 ulp at three of the 101 steps
(relative 1.3e-7 to 2.4e-7).  ``grad_norm`` sums in another order than
XLA:CPU, and an ulp of difference in the clip scale moves ``m`` near
zero by more than 1e-6 relative, so the gradients are drawn on a grid
fine enough for bf16 and coarse enough that every sum of their squares
is exact in f32: the norm is then the same in any order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

RTOL = 1e-6
SHAPES = {"embed": (64, 33), "norm": (7,), "experts": (3, 4, 5)}


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=10, total_steps=100),
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-3, warmup_steps=5, total_steps=4),  # the launcher's at 4 steps
])
def test_schedule_matches_reference(kw):
    got = [float(topt.schedule(topt.AdamWConfig(**kw), s)) for s in range(101)]
    want = [float(jopt.schedule(jopt.AdamWConfig(**kw), jnp.asarray(s)))
            for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("grad_scale, grid", [
    (0.3, 2**-4),  # global norm ~14: clipped
    (0.01, 2**-10),  # ~0.5: not clipped
])
def test_apply_updates_matches_reference(grad_scale, grid):
    """Three steps from identical f32 parameters with identical bf16
    gradients: parameters, ``m``, ``v``, ``step``, ``grad_norm``, ``lr``."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = jopt.init_state(pj), topt.init_state(pt)
    for _ in range(3):
        g = {k: jnp.asarray(np.round(rng.standard_normal(s) * grad_scale / grid)
                            * grid).astype(jnp.bfloat16) for k, s in SHAPES.items()}
        pj, sj, mj = jopt.apply_updates(jopt.AdamWConfig(**cfg), pj, g, sj)
        gt = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
              for k, v in g.items()}
        pt, st, mt = topt.apply_updates(topt.AdamWConfig(**cfg), pt, gt, st)
        for k in SHAPES:
            for got, want in ((pt[k], pj[k]), (st["m"][k], sj["m"][k]),
                              (st["v"][k], sj["v"][k])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                           atol=0, err_msg=k)
        assert int(st["step"]) == int(sj["step"]) and st["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=RTOL)
    clipped = float(mt["grad_norm"]) > 1.0
    assert clipped == (grad_scale == 0.3)


def test_apply_updates_leaves_gradients_alone():
    """An f32 gradient is read, not scaled in place."""
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 10.0)}
    topt.apply_updates(topt.AdamWConfig(), p, g, topt.init_state(p))
    assert torch.equal(g["w"], torch.full((4,), 10.0))


def test_state_keys_are_parameter_names():
    from repro_torch.configs import registry
    from repro_torch.models.api import build_model

    params = build_model(registry.get_config("qwen3-4b", smoke=True)).init_params(
        0, device="cpu")
    state = topt.init_state(params)
    assert set(state) == {"step", "m", "v"}
    assert list(state["m"]) == list(params.state_dict()) == list(state["v"])
    assert all(m.dtype == torch.float32 for m in state["m"].values())


# the reference's own checks (tests/test_train_substrate.py), on the port


def test_adamw_converges_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_state(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w**2), [w])
        params, state, _ = topt.apply_updates(cfg, params, {"w": g}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(topt.schedule(cfg, s)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # decay


def test_grad_clip():
    cfg = topt.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = topt.init_state(params)
    big = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, metrics = topt.apply_updates(cfg, params, big, state)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)
    # clipped to norm 1: the first step moves w by lr (Adam's unit step)
    want = jopt.apply_updates(jopt.AdamWConfig(clip_norm=1.0), {"w": jnp.zeros(3)},
                              {"w": jnp.asarray([100.0, 0.0, 0.0])},
                              jopt.init_state({"w": jnp.zeros(3)}))[0]["w"]
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(want), rtol=RTOL)

