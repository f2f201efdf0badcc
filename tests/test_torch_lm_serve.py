"""Port parity of the LM serving path at smoke size, dense and vlm archs
(qwen3-4b, qwen3-8b, yi-9b, qwen2-72b, internvl2-26b); the helpers and
checks the other families' files import
(``test_torch_lm_serve_{moe,hybrid,xlstm,encdec,ring}.py``):
``forward`` logits (whisper: encoder, cross K/V, decoder) and MoE
metrics, ``prefill``'s last logits and cache (attention K/V, cross K/V,
mamba/mLSTM/sLSTM states), teacher-forced ``decode_step`` tokens and
``ServeEngine.generate`` (``device="cpu"``) against ``repro.models`` /
``repro.serve.engine`` with the same parameters
(``convert.from_jax_params`` of the reference's ``jax.random`` init);
the converter's round trip.  The sliding-window ring, which the port
fixes and the reference gets wrong (ROADMAP Queue 3), is held in
``test_torch_lm_serve_ring.py``.

The reference runs op by op (``jax.disable_jit()``): every op rounded to
the dtype its source names, as the port rounds.  Compiled, XLA:CPU keeps
some bf16 intermediates of a fused scan body in f32, so the compiled
reference differs from its own op-by-op evaluation by a few hundredths
in the smoke archs' logits, and on moonshot's smoke config it routes a
token whose router sits near a tie to another expert, which moves that
token's logits by more than 1.

Tolerances: float results ``TOL`` (atol = rtol = 5e-2, the reference's
prefill-against-forward tolerance, ``tests/test_recurrent_parity.py``);
tokens equal wherever the reference's f32 top-2 logit gap exceeds
``TOKEN_MARGIN`` = twice that; integers bit-equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import encdec as jed, transformer as jtr  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["qwen3-4b", "qwen3-8b", "yi-9b", "qwen2-72b", "internvl2-26b"]
TOL = dict(atol=5e-2, rtol=5e-2)
TOKEN_MARGIN = 2 * TOL["atol"]
B, P, T = 2, 16, 6  # batch, prompt, new tokens (P = mixtral's smoke window)


def _gap(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _tokens_agree(got, want, ref_logits) -> None:
    """Teacher-forced tokens: equal wherever the reference's gap is clear."""
    clear = _gap(ref_logits) > TOKEN_MARGIN
    assert clear.mean() > 0.5, "too few clear positions to compare"
    np.testing.assert_array_equal(np.asarray(got)[clear], np.asarray(want)[clear])


def _greedy_agree(got, want, ref_logits) -> None:
    """Generated rows: equal at every clear position up to the first
    token that differs, which must sit at a position that is not clear
    (past it the two rows continue from other contexts)."""
    clear = _gap(ref_logits) > TOKEN_MARGIN
    compared = 0
    for g, w, c in zip(np.asarray(got), np.asarray(want), clear):
        for j in range(len(g)):
            if g[j] != w[j]:
                assert not c[j], f"token {j}: port {g[j]}, reference {w[j]}"
                break
            compared += int(c[j])
    assert compared >= len(clear), "too few clear positions to compare"


def _ref_forward(jcfg, params, tokens, fe=None):
    """The reference's full-sequence logits (whisper: encoder, cross K/V,
    decoder) and MoE metrics."""
    with jax.disable_jit():
        if jcfg.enc_dec:
            cross = jed.cross_caches(jcfg, params, jed.encode(jcfg, params, fe))
            logits = jed.decoder_forward(jcfg, params, jnp.asarray(tokens), cross,
                                         remat=False)
            return np.asarray(logits), {}
        logits, aux = jtr.forward(jcfg, params, jnp.asarray(tokens), fe, remat=False)
    return np.asarray(logits), {k: float(v) for k, v in aux.items()}


@dataclasses.dataclass
class Case:
    jcfg: object
    tcfg: object
    jparams: dict
    tparams: torch.nn.Module
    tokens: np.ndarray  # (B, P + T): the prompt and the teacher tokens
    extras: dict  # frontend_embeds (numpy): vit patches, audio frames
    n_front: int  # the vit stub's positions ahead of the text


def _case(arch: str, cfg_fn=lambda c: c) -> Case:
    jcfg = cfg_fn(jreg.get_config(arch, smoke=True))
    tcfg = cfg_fn(treg.get_config(arch, smoke=True))
    jparams = jbuild(jcfg).init_params(jax.random.key(0))
    tparams = build_model(tcfg).load_params(
        convert.from_jax_params(jax.device_get(jparams)), device="cpu"
    )
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_raw, (B, P + T)).astype(np.int32)
    extras, n_front = {}, 0
    if jcfg.frontend == "vit":
        n_front = jcfg.n_frontend_tokens
        extras["frontend_embeds"] = rng.standard_normal(
            (B, n_front, jcfg.d_frontend)
        ).astype(np.float32)
    elif jcfg.enc_dec:
        extras["frontend_embeds"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)
        ).astype(np.float32)
    return Case(jcfg, tcfg, jparams, tparams, tokens, extras, n_front)


@pytest.fixture(scope="module", params=ARCHS)
def case(request) -> Case:
    return _case(request.param)


def _fe(case: Case, lib: str):
    fe = case.extras.get("frontend_embeds")
    if fe is None:
        return None
    return torch.from_numpy(fe) if lib == "torch" else jnp.asarray(fe)


def check_forward(case: Case) -> None:
    """``forward``'s logits and MoE metrics and ``loss_fn``'s loss."""
    want, aux_j = _ref_forward(case.jcfg, case.jparams, case.tokens, _fe(case, "jax"))
    tm = build_model(case.tcfg)
    got, aux_t = tm.forward(case.tparams, {"tokens": torch.from_numpy(case.tokens),
                                           "frontend_embeds": _fe(case, "torch")})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert set(aux_t) == set(aux_j)
    for k in set(aux_j) - {"moe_dropped_frac"}:
        np.testing.assert_allclose(float(aux_t[k]), aux_j[k], **TOL)
    if aux_j:
        assert float(aux_t["moe_dropped_frac"]) == aux_j["moe_dropped_frac"]
    loss_t, _ = tm.loss_fn(case.tparams, {
        "tokens": torch.from_numpy(case.tokens),
        **{k: torch.from_numpy(v) for k, v in case.extras.items()},
    })
    jloss = jed.loss_fn if case.jcfg.enc_dec else jtr.loss_fn
    with jax.disable_jit():
        loss_j, _ = jloss(case.jcfg, case.jparams, {
            "tokens": jnp.asarray(case.tokens), **case.extras,
        }, remat=False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)


def check_prefill_and_decode(case: Case) -> None:
    """Prefill's last logits and cache (every slot's tensors: attention and
    cross K/V, recurrent states), then ``T`` teacher-forced decode steps:
    tokens against the reference's decode under the token rule."""
    jm, tm = jbuild(case.jcfg), build_model(case.tcfg)
    max_seq = case.n_front + P + T
    prompt = case.tokens[:, :P]
    with jax.disable_jit():
        last_j, cache_j = jm.prefill(case.jparams, {"tokens": prompt, **case.extras},
                                     max_seq=max_seq)
    last_t, cache_t = tm.prefill(case.tparams, {
        "tokens": torch.from_numpy(prompt),
        **{k: torch.from_numpy(v) for k, v in case.extras.items()},
    }, max_seq=max_seq)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TOL)
    assert cache_t.pos == int(cache_j["pos"]) == case.n_front + P
    layer = 0
    for g, (n_repeat, period) in enumerate(case.jcfg.layer_plan()):
        for r in range(n_repeat):
            assert set(cache_t.layers[layer]) == set(cache_j["groups"][g])
            for slot, c in cache_t.layers[layer].items():
                assert set(c) == set(cache_j["groups"][g][slot])
                for name, got in c.items():
                    want = cache_j["groups"][g][slot][name][r]
                    assert str(got.dtype) == f"torch.{want.dtype}", (slot, name)
                    assert tuple(got.shape) == want.shape, (slot, name)
                    np.testing.assert_allclose(got.float().numpy(),
                                               np.asarray(want.astype(jnp.float32)),
                                               **TOL, err_msg=f"{slot}.{name}")
            layer += 1

    ref_logits, _ = _ref_forward(case.jcfg, case.jparams, case.tokens, _fe(case, "jax"))
    got, want = [], []
    for j in range(T):
        tok = case.tokens[:, P + j : P + j + 1]
        with jax.disable_jit():
            nj, cache_j = jm.decode_step(case.jparams, cache_j, jnp.asarray(tok))
        nt, cache_t = tm.decode_step(case.tparams, cache_t, torch.from_numpy(tok))
        assert nt.dtype == torch.int32
        got.append(nt.numpy()[:, 0])
        want.append(np.asarray(nj)[:, 0])
    _tokens_agree(np.stack(got, 1), np.stack(want, 1),
                  ref_logits[:, case.n_front + P : case.n_front + P + T])


def check_serve_engine(case: Case) -> None:
    """``ServeEngine.generate`` under the greedy token rule."""
    prompt = case.tokens[:, :P]
    with jax.disable_jit():
        want = JServeEngine(jbuild(case.jcfg), params=case.jparams).generate(
            prompt, T, **case.extras
        )
    engine = ServeEngine(build_model(case.tcfg), params=case.tparams, device="cpu")
    got = engine.generate(prompt, T, **case.extras)
    assert got.shape == want.shape == (B, T) and got.dtype == np.int32
    assert engine.stats.logits_finite and engine.stats.decode_steps == T - 1
    ref_logits, _ = _ref_forward(
        case.jcfg, case.jparams, np.concatenate([prompt, want], axis=1), _fe(case, "jax")
    )
    lo = case.n_front + P - 1
    _greedy_agree(got, want, ref_logits[:, lo : lo + T])


def check_round_trip(case: Case) -> None:
    """Every leaf of the reference's tree lands in the port's parameters
    with its shape and bytes, and the port has no other parameter."""
    tree = jax.device_get(case.jparams)
    state = case.tparams.state_dict()
    seen = 0

    def check(leaf, name):
        nonlocal seen
        got = state[name].numpy()
        assert got.shape == leaf.shape and got.dtype == leaf.dtype == np.float32
        assert got.tobytes() == np.ascontiguousarray(leaf).tobytes(), name
        seen += 1

    def walk(t, prefix, index=None):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.", index)
            else:
                check(np.asarray(v) if index is None else np.asarray(v)[index], prefix + k)

    walk({k: v for k, v in tree.items() if k not in convert.GROUPS}, "")
    for key, name in convert.GROUPS.items():
        layer = 0
        for group in tree.get(key, ()):
            n_repeat = np.asarray(jax.tree.leaves(group)[0]).shape[0]
            for r in range(n_repeat):
                walk(group, f"{name}.{layer}.", r)
                layer += 1
    assert seen == len(state)
    names = set(state)
    cfg = case.jcfg
    assert any(n.endswith(".bq") for n in names) == cfg.qkv_bias
    assert any(n.endswith(".q_norm") for n in names) == cfg.qk_norm
    assert any(".shared." in n for n in names) == bool(cfg.moe and cfg.moe.n_shared)
    assert ("frontend.proj1" in names) == (cfg.frontend == "vit")


def test_forward_matches_reference(case):
    check_forward(case)


def test_prefill_and_decode_match_reference(case):
    check_prefill_and_decode(case)


def test_serve_engine_matches_reference(case):
    check_serve_engine(case)


def test_from_jax_params_round_trip(case):
    check_round_trip(case)


def test_serve_engine_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(build_model(treg.get_config("qwen3-4b", smoke=True)))
