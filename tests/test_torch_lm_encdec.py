"""Port parity of the encoder-decoder path: ``repro_torch.models.encdec``
and the bidirectional and cross-attention parts of
``repro_torch.models.attention`` against ``repro.models``'s, on whisper's
smoke config (2 encoder + 2 decoder layers, d 64, 16 stub frames) with
the same parameters (``convert.from_jax_params`` of the reference's
``jax.random`` init) and the same numpy inputs.

The reference runs op by op (``jax.disable_jit()``), every op rounded to
the dtype its source names, as the port rounds; the long-sequence
attention cases run f32 inputs under ``jax.jit`` (no bf16 intermediate
to keep wider), one sublayer a call.

Tolerances: float results ``TOL`` (atol = rtol = 5e-2,
``tests/test_torch_lm_serve.py``'s); decoded tokens equal wherever the
reference's f32 top-2 logit gap exceeds ``TOKEN_MARGIN`` = twice that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as ja, encdec as jed  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as ta, convert, encdec as ted  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

TOL = dict(atol=5e-2, rtol=5e-2)
TOKEN_MARGIN = 2 * TOL["atol"]
B, P, T = 2, 8, 6  # batch, prompt, decode steps


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def whisper():
    jcfg = jreg.get_config("whisper-medium", smoke=True)
    tcfg = treg.get_config("whisper-medium", smoke=True)
    jparams = jbuild(jcfg).init_params(jax.random.key(0))
    tparams = build_model(tcfg).load_params(
        convert.from_jax_params(jax.device_get(jparams)), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_raw, (B, P + T)).astype(np.int32)
    with jax.disable_jit():
        enc = jed.encode(jcfg, jparams, jnp.asarray(frames))
        cross = jed.cross_caches(jcfg, jparams, enc)
        logits = jed.decoder_forward(jcfg, jparams, jnp.asarray(tokens), cross, remat=False)
    ref = dict(enc=enc, cross=cross, logits=np.asarray(logits))
    return jcfg, tcfg, jparams, tparams, frames, tokens, ref


def test_encode_and_cross_caches_match_reference(whisper):
    jcfg, tcfg, _, tparams, frames, _, ref = whisper
    enc = ted.encode(tcfg, tparams, torch.from_numpy(frames))
    assert enc.dtype == torch.bfloat16 and tuple(enc.shape) == ref["enc"].shape
    np.testing.assert_allclose(_np(enc), _np(ref["enc"]), **TOL)
    cross = ted.cross_caches(tcfg, tparams, enc)
    layer = 0
    for g, (n_repeat, _) in enumerate(jcfg.layer_plan()):
        for r in range(n_repeat):
            assert set(cross[layer]) == set(ref["cross"][g])
            for slot, kv in cross[layer].items():
                for name in ("k", "v"):
                    want = ref["cross"][g][slot][name][r]
                    assert kv[name].dtype == torch.bfloat16 and tuple(kv[name].shape) == want.shape
                    np.testing.assert_allclose(_np(kv[name]), _np(want), **TOL)
            layer += 1


def test_decoder_forward_and_loss_match_reference(whisper):
    jcfg, tcfg, jparams, tparams, frames, tokens, ref = whisper
    logits, aux = ted.forward(tcfg, tparams, torch.from_numpy(tokens), torch.from_numpy(frames))
    assert logits.dtype == torch.float32 and aux == {}
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    batch = {"tokens": tokens, "frontend_embeds": frames}
    loss_t, metrics = ted.loss_fn(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    with jax.disable_jit():
        loss_j, _ = jed.loss_fn(jcfg, jparams, batch, remat=False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    assert float(metrics["loss"]) == float(loss_t)


def test_prefill_and_decode_step_match_reference(whisper):
    """Prefill's last logits and cache (self-attention K/V padded to
    ``max_seq``, cross K/V), then ``T`` teacher-forced decode steps."""
    jcfg, tcfg, jparams, tparams, frames, tokens, ref = whisper
    prompt = tokens[:, :P]
    with jax.disable_jit():
        last_j, cache_j = jed.prefill(jcfg, jparams, jnp.asarray(prompt),
                                      jnp.asarray(frames), max_seq=P + T)
    last_t, cache_t = ted.prefill(tcfg, tparams, torch.from_numpy(prompt),
                                  torch.from_numpy(frames), max_seq=P + T)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TOL)
    assert cache_t.pos == int(cache_j["pos"]) == P
    layer = 0
    for g, (n_repeat, _) in enumerate(jcfg.layer_plan()):
        for r in range(n_repeat):
            assert set(cache_t.layers[layer]) == set(cache_j["groups"][g])
            for slot, c in cache_t.layers[layer].items():
                for name in ("k", "v"):
                    want = cache_j["groups"][g][slot][name][r]
                    assert c[name].dtype == torch.bfloat16 and tuple(c[name].shape) == want.shape
                    np.testing.assert_allclose(_np(c[name]), _np(want), **TOL)
            layer += 1
    got, want = [], []
    for j in range(T):
        tok = tokens[:, P + j : P + j + 1]
        with jax.disable_jit():
            nj, cache_j = jed.decode_step(jcfg, jparams, cache_j, jnp.asarray(tok))
        nt, cache_t = ted.decode_step(tcfg, tparams, cache_t, torch.from_numpy(tok))
        got.append(nt.numpy()[:, 0])
        want.append(np.asarray(nj)[:, 0])
    top2 = np.sort(ref["logits"][:, P : P + T], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TOKEN_MARGIN
    assert clear.mean() > 0.5, "too few clear positions to compare"
    np.testing.assert_array_equal(np.stack(got, 1)[clear], np.stack(want, 1)[clear])


def _attn_pair(whisper, slot: str):
    """A sublayer's reference and port parameters (first layer)."""
    jcfg, tcfg, jparams, tparams, *_ = whisper
    if slot.endswith("attn_bidir"):
        jp = jax.tree.map(lambda a: a[0], jparams["enc_groups"][0][slot])
        tp = tparams.enc_layers[0][slot]
    else:
        jp = jax.tree.map(lambda a: a[0], jparams["dec_groups"][0][slot])
        tp = tparams.layers[0][slot]
    return jcfg, tcfg, jp, tp


def _x(s: int, d: int) -> np.ndarray:
    return (np.random.default_rng(s).standard_normal((B, s, d)) * 0.5).astype(np.float32)


def test_attend_cross_chunked_matches_reference(whisper):
    """A 2,100-token query (above ``CHUNK_THRESHOLD``) against 16 frames
    and against 1,500 (whisper's count; not a ``KV_BLOCK`` multiple, so
    the kv is padded and masked by its length); also the dense path at
    the prompt's length."""
    jcfg, tcfg, jp, tp = _attn_pair(whisper, "01_cross")
    for n_frames in (jcfg.n_frontend_tokens, 1500):
        _cross_case(jcfg, tcfg, jp, tp, _x(n_frames, jcfg.d_model))
    assert 2100 > ta.CHUNK_THRESHOLD == ja.CHUNK_THRESHOLD


def _cross_case(jcfg, tcfg, jp, tp, enc):
    kv_j = ja.encode_cross_kv(jp, jcfg, jnp.asarray(enc))
    kv_t = ta.encode_cross_kv(tp, tcfg, torch.from_numpy(enc))
    for s in (P, 2100):
        x = _x(s, jcfg.d_model)
        want = jax.jit(lambda p, x, kv: ja.attend_cross(p, jcfg, x, kv))(
            jp, jnp.asarray(x), kv_j)
        got = ta.attend_cross(tp, tcfg, torch.from_numpy(x), kv_t)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [64, 2560])
def test_attend_full_bidirectional_matches_reference(whisper, s):
    """``causal=False`` dense (64 tokens) and chunked (2,560, above
    ``CHUNK_THRESHOLD``), with the K/V it returns."""
    jcfg, tcfg, jp, tp = _attn_pair(whisper, "00_attn_bidir")
    x = _x(s, jcfg.d_model)
    pos = np.arange(s, dtype=np.int32)[None, :]
    yj, (kj, vj) = jax.jit(lambda p, x: ja.attend_full(
        p, jcfg, x, jnp.asarray(pos), causal=False, return_kv=True))(jp, jnp.asarray(x))
    yt, (kt, vt) = ta.attend_full(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                  causal=False, return_kv=True)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a bidirectional row sees its future: the causal output differs
    causal = ta.attend_full(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert not torch.allclose(causal[:, :-1], yt[:, :-1], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_pads_a_ragged_length(causal):
    """At 2,600 tokens (not a block multiple; the reference halves its
    blocks to 8 tokens) the port pads its last query and kv blocks: the
    result is the dense softmax's, the port's and the reference's (f32,
    ``tests/test_attention.py``'s atol=3e-5)."""
    rng = np.random.default_rng(0)
    s = 2600
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * sc
               for shape, sc in (((1, s, 4, 16), 0.3), ((1, s, 2, 16), 0.3),
                                 ((1, s, 2, 16), 1.0)))
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (j <= i) if causal else np.ones((s, s), bool)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = ta._sdpa_chunked(qt, kt, vt, 2, causal=causal)
    assert tuple(out.shape) == q.shape
    dense = ta._sdpa(qt, kt, vt, torch.from_numpy(mask)[None], 2)
    want = jax.jit(lambda q, k, v: ja._sdpa(q, k, v, jnp.asarray(mask)[None], 2))(q, k, v)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-5, rtol=0)
