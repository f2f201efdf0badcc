"""The port's train step (``repro_torch.train.train_loop``) and launcher
(``repro_torch.launch.train``) on the CPU: the reference's checks
(``tests/test_train_substrate.py``: losses fall over 30 steps, the
microbatched step agrees with the full one, resume replays the
uninterrupted run) on the port; the port's launcher against the
reference's ``train`` from the same parameters; one step of every arch;
the bf16 gradients; serving records no autograd graph; and the launcher
refuses to fall back to the host or to take a mesh larger than its
world.

Tolerances: the launcher's losses against the reference's
``rtol=2e-2`` (the reference's resume tolerance; measured 7.1e-4 on
qwen3-4b and 3.5e-3 on mixtral over 8 steps); the microbatched update
against the full one the reference's ``dd < 0.35 * d1`` (bf16 weights
and gradients: the direction must agree); resume on the CPU exact.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt, train_loop as jloop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api, convert  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import optimizer as opt_lib, train_loop  # noqa: E402

ARCHS = list(registry.ARCHS)


def _batch(cfg, b: int, s: int, step: int = 0) -> dict:
    """A ``SyntheticLM`` batch, with seeded frames or patches where the
    arch takes them."""
    batch = SyntheticLM(PipelineConfig(cfg.vocab_raw, s, b)).batch_at(step)
    if cfg.frontend != "none":
        batch["frontend_embeds"] = np.random.default_rng(step).standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _l1(tensors) -> float:
    return sum(float(t.detach().abs().sum()) for t in tensors)


def test_train_step_reduces_loss():
    cfg = registry.get_config("qwen3-8b", smoke=True)
    model = build_model(cfg)
    step = train_loop.build_train_step(
        model, opt_lib.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60))
    params = model.trainable(model.init_params(0, device="cpu"))
    opt_state = opt_lib.init_state(params)
    losses = []
    for s in range(30):
        params, opt_state, metrics = step(params, opt_state, _batch(cfg, 8, 32, s % 4))
        losses.append(float(metrics["loss_total"]))
    assert losses[-1] < losses[0] * 0.9, losses[::6]


def _one_step(model, params, batch, microbatches, **opt):
    p = model.trainable(build_model(model.cfg).load_params(params.state_dict(), "cpu"))
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(**opt),
                                       microbatches=microbatches)
    return step(p, opt_lib.init_state(p), batch)


def test_microbatched_matches_full_grads():
    cfg = registry.get_config("yi-9b", smoke=True)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    batch = _batch(cfg, 8, 16)
    p1, _, m1 = _one_step(model, params, batch, 1)
    p4, _, m4 = _one_step(model, params, batch, 4)
    d1 = _l1(a - b for a, b in zip(p1.parameters(), params.parameters()))
    dd = _l1(a - b for a, b in zip(p1.parameters(), p4.parameters()))
    assert dd < 0.35 * d1, (dd, d1)
    assert set(m4) == {"loss_total", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m4["loss_total"]), float(m1["loss_total"]), rtol=2e-2)


def test_microbatched_step_matches_reference():
    """The port's microbatched step and the reference's, from the same
    parameters: their updates agree under ``dd < 0.35 * d1``, and so do
    the losses within ``rtol=2e-2``."""
    jcfg = jreg.get_config("yi-9b", smoke=True)
    jparams = jbuild(jcfg).init_params(jax.random.key(0))
    model = build_model(registry.get_config("yi-9b", smoke=True))
    params = model.load_params(convert.from_jax_params(jax.device_get(jparams)), "cpu")
    batch = _batch(model.cfg, 8, 16)
    pt, _, mt = _one_step(model, params, batch, 4)
    step_j = jloop.build_train_step(jbuild(jcfg), jopt.AdamWConfig(), microbatches=4)
    pj, _, mj = jax.jit(step_j)(jparams, jopt.init_state(jparams),
                                {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    pj = convert.from_jax_params(jax.device_get(pj))
    d1 = _l1(pj[n] - p for n, p in params.state_dict().items())
    dd = _l1(pj[n] - p.detach() for n, p in pt.named_parameters())
    assert dd < 0.35 * d1, (dd, d1)
    np.testing.assert_allclose(float(mt["loss_total"]), float(mj["loss_total"]), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_every_arch(arch):
    """One step on each arch (whisper's and internvl2's batches carry
    frames or patches): the step-0 loss equals ``loss_fn`` of the same
    parameters under ``inference_mode`` (no graph, no remat), every
    metric is finite, the norm positive, every parameter moved or held
    by a zero gradient, and the state counts one step."""
    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.trainable(model.init_params(0, device="cpu"))
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    batch = _batch(cfg, 2, 16)
    with torch.inference_mode():
        want, _ = model.loss_fn(params, batch)
    state = opt_lib.init_state(params)
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1))
    _, state, metrics = step(params, state, batch)
    assert float(metrics["loss_total"]) == float(want)
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0 and int(state["step"]) == 1
    if cfg.moe:
        assert float(metrics["moe_lb_loss"]) > 0 and float(metrics["moe_z_loss"]) > 0
    moved = [n for n, p in params.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) == len(before)  # weight decay moves even a zero-gradient leaf
    assert all(p.grad is None for p in params.parameters())


def test_grads_are_autograd_s_rounded_to_bf16():
    """``grads_of`` keeps each gradient as autograd finished it, rounded
    to bf16, and zeros where the loss does not reach (the vit projector
    without patches), as ``jax.grad`` gives."""
    cfg = registry.get_config("internvl2-26b", smoke=True)
    model = build_model(cfg)
    params = model.trainable(model.init_params(0, device="cpu"))
    batch = {"tokens": _batch(cfg, 2, 16)["tokens"]}
    loss, metrics, grads = train_loop.grads_of(model, params, batch)
    total, _ = model.loss_fn(params, batch)
    names = [n for n, _ in params.named_parameters()]
    want = torch.autograd.grad(total, list(params.parameters()), allow_unused=True)
    for n, w in zip(names, want):
        assert grads[n].dtype == torch.bfloat16, n
        ref = torch.zeros_like(grads[n]) if w is None else w.to(torch.bfloat16)
        assert torch.equal(grads[n], ref), n
    assert not float(grads["frontend.proj1"].abs().sum())
    assert float(loss) == float(total) == float(metrics["loss"])


def test_train_resume_equivalence(tmp_path):
    """Stop/restore mid-run == uninterrupted run, exactly on the CPU."""
    d = str(tmp_path / "ck")
    kw = dict(smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,), log_every=100,
              device="cpu")
    l_full = ttrain.train("qwen3-4b", ckpt_dir=None, **kw)
    ttrain.train("qwen3-4b", **{**kw, "steps": 4}, ckpt_dir=d, ckpt_every=4)
    l_resumed = ttrain.train("qwen3-4b", ckpt_dir=d, ckpt_every=100, resume=True, **kw)
    assert l_resumed == l_full[4:]


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x7b"])
def test_train_matches_reference_train(monkeypatch, arch):
    """The port's launcher and the reference's (``repro.launch.train``)
    from the same parameters (the reference's ``jax.random.key(0)`` init,
    converted) over the same 8 ``SyntheticLM`` batches."""
    want = jtrain.train(arch, smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,),
                        log_every=100)
    jparams = jbuild(jreg.get_config(arch, smoke=True)).init_params(jax.random.key(0))
    sd = convert.from_jax_params(jax.device_get(jparams))
    monkeypatch.setattr(api.Model, "init_params",
                        lambda self, seed=0, device="cuda": self.load_params(sd, device))
    got = ttrain.train(arch, smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,),
                       log_every=100, device="cpu")
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train("qwen3-4b", steps=1, batch=2, seq=8)


@pytest.mark.parametrize("shape", [(2,), (1, 2), (4, 4)])
def test_train_refuses_a_mesh(shape):
    """Without a process group the world size is 1: a mesh of more ranks
    is refused, naming both numbers."""
    n = int(np.prod(shape))
    with pytest.raises(ValueError, match=rf"holds {n} ranks, the world size is 1"):
        ttrain.train("qwen3-4b", steps=1, mesh_shape=shape, device="cpu")


def test_main_trains_on_the_host(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-4b", "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "8", "--device", "cpu", "--mesh-shape", "1"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out and "first loss" in out


class _Recording:
    """A model facade whose prefill and decode record autograd's state."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _record(self, out):
        logits = out[0]
        self.seen.append((torch.is_inference_mode_enabled(), logits.grad_fn))
        return out

    def prefill(self, *a, **k):
        return self._record(self.model.prefill(*a, **k))

    def decode_logits(self, *a, **k):
        return self._record((self.model.decode_logits(*a, **k),))[0]


def test_serving_trained_parameters_records_no_graph():
    """``ServeEngine.generate`` over parameters a trainer marked trained
    runs under ``inference_mode``: no logits carry a ``grad_fn``."""
    cfg = registry.get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)
    params = model.trainable(model.init_params(0, device="cpu"))
    rec = _Recording(model)
    ServeEngine(rec, params=params, device="cpu").generate(
        _batch(cfg, 2, 8)["tokens"].numpy(), 4)
    assert len(rec.seen) == 4
    assert all(mode and fn is None for mode, fn in rec.seen)
    assert all(p.requires_grad for p in params.parameters())


def test_serve_step_and_prefill_builders():
    """``build_prefill`` and ``build_serve_step`` are the facade's prefill
    and decode step under ``inference_mode``: the same tokens, no graph."""
    cfg = registry.get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)
    params = model.trainable(model.init_params(0, device="cpu"))
    batch = {"tokens": _batch(cfg, 2, 8)["tokens"]}
    last, cache = train_loop.build_prefill(model)(params, batch)
    want_last, _ = model.prefill(params, batch)
    assert last.grad_fn is None and torch.equal(last, want_last.detach())
    assert cache.pos == 8
    tok = last.argmax(-1).to(torch.int32)[:, None]
    cache = model.prefill(params, batch, max_seq=12)[1]
    want_cache = model.prefill(params, batch, max_seq=12)[1]
    nxt, cache = train_loop.build_serve_step(model)(params, cache, tok)
    want, _ = model.decode_step(params, want_cache, tok)
    assert torch.equal(nxt, want) and cache.pos == 9
