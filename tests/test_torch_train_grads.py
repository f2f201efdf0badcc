"""Port parity of the backward pass, dense and vit archs: the port's
``loss_fn`` and every gradient leaf (``torch.autograd``) against
``jax.value_and_grad`` of the reference's ``loss_fn`` with the same
parameters (``convert.from_jax_params`` of the reference's init; the same
converter maps the reference's gradient tree onto the port's names), at
smoke size; the port's gradients with per-layer remat equal to those
without it, bit for bit; every gradient finite.  Also the blockwise
attention's backward (``_sdpa_chunked``: a ragged last block, a window,
bidirectional) against the dense softmax's and the reference's.  The
MoE archs are in ``test_torch_train_grads_moe.py``, whisper in
``_encdec.py``, jamba in ``_recurrent.py`` and xlstm in ``_xlstm.py``
(the same checks, from the helpers here); ``apply_mamba``'s backward
across chunks in ``_mamba.py``.

The reference runs op by op (``jax.disable_jit()``), as
``tests/test_torch_lm_serve.py`` runs it.

Tolerances: the loss ``TOL`` (atol = rtol = 5e-2, the serving tests');
each gradient leaf by its relative L2 error, ``|g - g_ref| / max(|g_ref|,
GRAD_FLOOR * |G_ref|)`` (``G_ref`` the whole gradient) ``<= GRAD_TOL`` =
0.05.  Measured maxima (this file: 0.0166, qwen2-72b's ``bk``; MoE
0.0138, moonshot's ``attn.norm``; whisper 0.0219, ``mlp.norm``; jamba
0.0222, ``mamba.D``; xlstm 0.0140, ``mlstm.norm``) come from bf16
activations rounded at other points of the backward pass.  ``GRAD_FLOOR`` = 1e-3 keeps a leaf whose gradient is
zero in exact arithmetic from dividing rounding noise by rounding noise:
sLSTM's input-gate bias, shared by every step, cancels in ``c / n``
(both sides' gradients ~1e-9 against ~0.4 for its weight).  The
blockwise attention is f32: ``atol=3e-5`` as its forward's test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import encdec as jed, transformer as jtr  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as ta, convert  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

TOL = dict(atol=5e-2, rtol=5e-2)
GRAD_TOL, GRAD_FLOOR = 0.05, 1e-3
B, S = 2, 16
ARCHS = ["qwen3-4b", "qwen3-8b", "yi-9b", "qwen2-72b", "internvl2-26b"]


@dataclasses.dataclass
class GradCase:
    arch: str
    loss_ref: float
    grads_ref: dict  # port name -> f32 numpy
    loss: dict  # remat -> float
    grads: dict  # remat -> {port name: f32 tensor}


def grad_case(arch: str) -> GradCase:
    """The reference's loss and gradients (op by op, no remat) and the
    port's with and without remat, on the same parameters and batch."""
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = treg.get_config(arch, smoke=True)
    jparams = jbuild(jcfg).init_params(jax.random.key(0))
    model = build_model(tcfg)
    tparams = model.trainable(model.load_params(
        convert.from_jax_params(jax.device_get(jparams)), device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_raw, (B, S)).astype(np.int32)}
    if jcfg.frontend == "vit":
        batch["frontend_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_frontend)).astype(np.float32)
    elif jcfg.enc_dec:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)

    jloss = jed.loss_fn if jcfg.enc_dec else jtr.loss_fn
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        (loss_ref, _), g = jax.value_and_grad(
            lambda p: jloss(jcfg, p, jbatch, remat=False), has_aux=True)(jparams)
    grads_ref = {k: v.numpy() for k, v in convert.from_jax_params(
        jax.device_get(g)).items()}

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    names = [n for n, _ in tparams.named_parameters()]
    loss, grads = {}, {}
    for remat in (False, True):
        total, _ = model.loss_fn(tparams, tbatch, remat=remat)
        gs = torch.autograd.grad(total, list(tparams.parameters()))
        loss[remat], grads[remat] = float(total.detach()), dict(zip(names, gs))
    return GradCase(arch, float(loss_ref), grads_ref, loss, grads)


def check_against_reference(case: GradCase) -> float:
    """Loss within ``TOL``; every leaf finite and within ``GRAD_TOL``;
    returns the largest per-leaf error."""
    np.testing.assert_allclose(case.loss[False], case.loss_ref, **TOL)
    got = case.grads[False]
    assert set(got) == set(case.grads_ref)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in case.grads_ref.values()))
    worst = 0.0
    for name, want in case.grads_ref.items():
        g = got[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape, name
        assert bool(torch.isfinite(g).all()), f"{case.arch}: {name} not finite"
        err = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want),
                                                     GRAD_FLOOR * total)
        assert err <= GRAD_TOL, f"{case.arch}: {name} relative L2 error {err}"
        worst = max(worst, float(err))
    return worst


def check_remat(case: GradCase) -> None:
    """Remat recomputes the same numbers: loss and every leaf bit-equal."""
    assert case.loss[True] == case.loss[False]
    for name, g in case.grads[False].items():
        assert torch.equal(case.grads[True][name], g), f"{case.arch}: {name}"


@pytest.fixture(scope="module", params=ARCHS)
def case(request) -> GradCase:
    return grad_case(request.param)


def test_loss_and_grads_match_reference(case):
    check_against_reference(case)


def test_remat_grads_are_bit_equal(case):
    check_remat(case)


# ---------------------------------------------------------------------------
# the blockwise attention's backward pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 150), (False, 0)])
def test_sdpa_chunked_backward(monkeypatch, causal, window):
    """Blocks of 64 queries and 128 keys over 600 tokens (a padded last
    query and kv block; with the window, whole kv blocks skipped): dq,
    dk, dv of the blockwise attention equal the dense softmax's (the
    port's ``_sdpa`` under the same mask) and the reference's dense
    ``_sdpa`` ``jax.vjp``, for one cotangent."""
    monkeypatch.setattr(ta, "Q_BLOCK", 64)
    monkeypatch.setattr(ta, "KV_BLOCK", 128)
    rng = np.random.default_rng(0)
    s = 600
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32) * sc for shape, sc in (
        ((1, s, 4, 16), 0.3), ((1, s, 2, 16), 0.3), ((1, s, 2, 16), 1.0),
        ((1, s, 4, 16), 1.0)))
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (j <= i) if causal else np.ones((s, s), bool)
    if window:
        mask &= j > i - window

    def grads(fn):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        fn(qt, kt, vt).backward(torch.from_numpy(w))
        return [t.grad for t in (qt, kt, vt)]

    chunked = grads(lambda q, k, v: ta._sdpa_chunked(q, k, v, 2, causal=causal,
                                                     window=window))
    dense = grads(lambda q, k, v: ta._sdpa(q, k, v, torch.from_numpy(mask)[None], 2))
    _, vjp = jax.vjp(lambda q, k, v: ja._sdpa(q, k, v, jnp.asarray(mask)[None], 2),
                     q, k, v)
    ref = vjp(jnp.asarray(w))
    for name, c, d, r in zip("qkv", chunked, dense, ref):
        assert bool(torch.isfinite(c).all()), name
        np.testing.assert_allclose(c.numpy(), d.numpy(), atol=3e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(c.numpy(), np.asarray(r), atol=3e-5, rtol=0,
                                   err_msg=name)
