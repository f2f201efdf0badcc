"""The sliding-window ring at smoke size (mixtral-8x7b: window 16),
which the port fixes and the reference gets wrong (ROADMAP Queue 3): the
reference's prefill keeps ``k[:, -window:]`` while its decode writes at
``pos % window``; the port holds token ``t`` at ``t % ring``.  The token
rules are ``test_torch_lm_serve.py``'s."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models.api import build_model as jbuild  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from test_torch_lm_serve import (  # noqa: E402
    TOKEN_MARGIN,
    B,
    Case,
    T,
    _case,
    _gap,
    _greedy_agree,
    _ref_forward,
    _tokens_agree,
)


def _no_drop(cfg):
    """Capacity n_experts / top_k: forward drops no MoE token (decode's 4.0
    drops none at this batch), so only the cache can differ."""
    m = cfg.moe
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    )


@pytest.fixture(scope="module")
def ring_case() -> Case:
    return _case("mixtral-8x7b", _no_drop)


def _ring_prompt(case: Case, p: int) -> np.ndarray:
    return np.random.default_rng(p).integers(0, case.jcfg.vocab_raw, (B, p)).astype(np.int32)


def _generate_both(case: Case, prompt: np.ndarray):
    with jax.disable_jit():
        ref = JServeEngine(jbuild(case.jcfg), params=case.jparams).generate(prompt, T)
    port = ServeEngine(build_model(case.tcfg), params=case.tparams,
                       device="cpu").generate(prompt, T)
    return port, ref


def _next_token_logits(case, prompt, gen, lib):
    """Both frameworks' forward over prompt + ``gen``, at the positions
    that predict ``gen``."""
    seq = np.concatenate([prompt, gen], axis=1)
    p = prompt.shape[1]
    if lib == "jax":
        logits, _ = _ref_forward(case.jcfg, case.jparams, seq)
    else:
        logits = ttr.forward(case.tcfg, case.tparams, torch.from_numpy(seq))[0].numpy()
    return logits[:, p - 1 : p - 1 + T]


@pytest.mark.parametrize("p", [8, 16, 24])
def test_sliding_window_decode_matches_forward(ring_case, p):
    """Below, at and not at a multiple of the window, the port's decode is
    its own and the reference's ``forward`` argmax under the token rule; at
    P = 16 its tokens are the reference's decode's."""
    prompt = _ring_prompt(ring_case, p)
    port, ref = _generate_both(ring_case, prompt)
    for lib in ("torch", "jax"):
        fwd = _next_token_logits(ring_case, prompt, port, lib)
        _tokens_agree(port, fwd.argmax(-1), fwd)
    if p % ring_case.jcfg.window == 0:
        _greedy_agree(port, ref, _next_token_logits(ring_case, prompt, ref, "jax"))


@pytest.mark.parametrize("p", [8, 24])
def test_reference_sliding_window_decode_fault(ring_case, p):
    """Pins the reference's fault (ROADMAP Queue 3): its prefill keeps
    ``k[:, -window:]`` (a ring only P long when P < window; token ``t`` at
    slot ``t - (P - window)``) while decode writes at ``pos % window``, so
    its decode leaves ``forward``'s argmax at clear positions."""
    prompt = _ring_prompt(ring_case, p)
    _, ref = _generate_both(ring_case, prompt)
    fwd = _next_token_logits(ring_case, prompt, ref, "jax")
    clear = _gap(fwd) > TOKEN_MARGIN
    assert (ref != fwd.argmax(-1))[clear].any()
