"""Port parity of the LM layers: ``repro_torch.models.{layers,attention,moe}``
against ``repro.models``'s on the same numpy inputs and the same
parameters (the reference's ``jax.random`` init, loaded into the port's
modules).  The reference runs under ``jax.jit``, one sublayer a call.

Tolerances, stated per result:

* bf16 results of elementwise functions, norms and single products:
  ``BF16_TOL`` (atol = rtol = 1e-2, about two bf16 ulps at 1.0);
* f32 results: ``F32_TOL`` (1e-5), and the chunked attention at the
  reference's own ``atol=3e-5`` (``tests/test_attention.py``);
* bf16 results of whole sublayers (attention, MoE): ``LAYER_TOL``
  (atol = rtol = 5e-2, the reference's prefill-against-forward tolerance,
  ``tests/test_recurrent_parity.py``);
* integers (expert ids, ``bucket_matrix``'s grid, validity and counts):
  bit-equal — expert ids wherever the k-th and (k+1)-th router
  probabilities differ by more than ``ROUTE_MARGIN``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.models import attention as ja, layers as jl, moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.models import attention as ta, layers as tl, moe as tmoe  # noqa: E402

BF16_TOL = dict(atol=1e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = dict(atol=5e-2, rtol=5e-2)
ROUTE_MARGIN = 1e-3


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Fill ``module`` with a reference parameter subtree."""
    def flat(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, torch.from_numpy(np.array(v, np.float32))

    module.load_state_dict(dict(flat(tree)))
    return module


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------


def _elementwise_cases():
    x = _rand((2, 8, 64), 0, 2.0)
    w, b = _rand((64,), 1) + 1.0, _rand((64,), 2)
    pos = np.arange(8, dtype=np.int32)[None]
    return {
        "rms_norm": (
            lambda m, x, dt: m.rms_norm(x, w if m is jl else torch.from_numpy(w), 1e-5),
            x,
        ),
        "layer_norm": (
            lambda m, x, dt: m.layer_norm(
                x, *((w, b) if m is jl else (torch.from_numpy(w), torch.from_numpy(b)))
            ),
            x,
        ),
        "silu": (lambda m, x, dt: m.silu(x), x),
        "gelu": (lambda m, x, dt: (jax.nn.gelu(x) if m is jl else tl.gelu(x)), x),
        "apply_rope": (
            lambda m, x, dt: m.apply_rope(
                x.reshape(2, 8, 4, 16),
                *m.rope_cos_sin(pos if m is jl else torch.from_numpy(pos), 16, 10_000.0),
            ),
            x,
        ),
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(_elementwise_cases()))
def test_layer_function_matches(name, dtype):
    fn, x = _elementwise_cases()[name]
    xj, xt = _pair(x, dtype)
    got, want = fn(tl, xt, dtype), fn(jl, xj, dtype)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("d_head,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_cos_sin_and_sinusoids(d_head, theta):
    pos = np.arange(0, 5000, 7, dtype=np.int32)[None]
    cj, sj = jl.rope_cos_sin(pos, d_head, theta)
    ct, st = tl.rope_cos_sin(torch.from_numpy(pos), d_head, theta)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32_TOL)
    np.testing.assert_allclose(
        tl.sinusoidal_positions(64, d_head).numpy(),
        np.asarray(jl.sinusoidal_positions(64, d_head)), **F32_TOL,
    )


def test_mlp_matches():
    p = jl.init_mlp(jax.random.key(0), 64, 128)
    mod = _load(tl.MLP(64, 128), p)
    xj, xt = _pair(_rand((2, 8, 64), 3), "bfloat16")
    np.testing.assert_allclose(
        _np(tl.apply_mlp(mod, xt)), _np(jl.apply_mlp(p, xj)), **BF16_TOL
    )


def test_he_init_statistics():
    g = torch.Generator().manual_seed(0)
    w = tl.he_init((512, 256), g, scale=0.5)
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 0.5 / 512**0.5) < 1e-3
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(tl.he_init((512, 256), g2, scale=0.5), w)


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------


def _qkv(b=2, s=4096, h=4, kv=2, hd=16):
    """``tests/test_attention.py``'s shapes, from numpy."""
    q = _rand((b, s, h, hd), 10, 0.3)
    k = _rand((b, s, kv, hd), 11, 0.3)
    v = _rand((b, s, kv, hd), 12)
    return q, k, v


def _causal(s, window):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    return mask


@pytest.mark.parametrize("window", [0, 100, 4096])
def test_sdpa_chunked_matches(window):
    q, k, v = _qkv()
    out_j = ja._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                             causal=True, window=window)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out_t = ta._sdpa_chunked(qt, kt, vt, 2, window=window)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=3e-5)
    # and the port's chunked path against its dense one
    dense = ta._sdpa(qt, kt, vt, torch.from_numpy(_causal(q.shape[1], window))[None], 2)
    np.testing.assert_allclose(out_t.numpy(), dense.numpy(), atol=3e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sdpa_dense_matches(dtype):
    q, k, v = _qkv(s=40)
    mask = _causal(40, 7)[None]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    got = ta._sdpa(qt, kt, vt, torch.from_numpy(mask), 2)
    want = ja._sdpa(qj, kj, vj, jnp.asarray(mask), 2)
    np.testing.assert_allclose(
        _np(got), _np(want), **(BF16_TOL if dtype == "bfloat16" else F32_TOL)
    )


def _attn(arch):
    jcfg, tcfg = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    p = ja.init_attn(jax.random.key(0), jcfg)
    return jcfg, tcfg, p, _load(ta.Attention(tcfg), p)


@pytest.mark.parametrize("arch,window", [
    ("qwen3-8b", 0), ("qwen2-72b", 0), ("mixtral-8x7b", 16),
])
def test_attend_full_matches(arch, window):
    jcfg, tcfg, pj, pt = _attn(arch)
    xj, xt = _pair(_rand((2, 24, jcfg.d_model), 4), "bfloat16")
    pos = np.arange(24, dtype=np.int32)[None]
    yj, (kj, vj) = jax.jit(lambda p, x: ja.attend_full(
        p, jcfg, x, pos, window=window, return_kv=True))(pj, xj)
    yt, (kt, vt) = ta.attend_full(pt, tcfg, xt, torch.from_numpy(pos), window=window,
                                  return_kv=True)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


def test_attend_decode_matches():
    """``attend_decode`` over a cache of 8 tokens padded to 16 (the shapes of
    ``tests/test_attention.py::test_decode_matches_full_prefix``)."""
    jcfg, tcfg, pj, pt = _attn("qwen3-8b")
    x = _rand((2, 9, jcfg.d_model), 5)
    xj, xt = _pair(x, "bfloat16")
    pos = np.arange(9, dtype=np.int32)[None]
    _, (kk, vv) = jax.jit(lambda p, x: ja.attend_full(
        p, jcfg, x, pos, return_kv=True))(pj, xj)
    pad = ((0, 0), (0, 8), (0, 0), (0, 0))
    cj = {"k": jnp.pad(kk[:, :8], pad), "v": jnp.pad(vv[:, :8], pad)}
    ct = {n: torch.tensor(_np(a)).to(torch.bfloat16) for n, a in cj.items()}
    yj, new = jax.jit(lambda p, x, c: ja.attend_decode(
        p, jcfg, x, c, jnp.asarray(8, jnp.int32)))(pj, xj[:, 8:9], cj)
    yt = ta.attend_decode(pt, tcfg, xt[:, 8:9], ct, 8)
    np.testing.assert_allclose(_np(yt), _np(yj), **LAYER_TOL)
    np.testing.assert_allclose(_np(ct["k"]), _np(new["k"]), **LAYER_TOL)
    with pytest.raises(ValueError):
        ta.attend_decode(pt, tcfg, xt[:, 8:9], ct, 16)


@pytest.mark.parametrize("pos", [5, 16, 21])
def test_attend_rolling_matches_reference_ring(pos):
    """The port's rolling decode against the reference's ``_decode_rolling``
    on the same ring (slot ``t % 16`` holding token ``t``), before and
    after it wraps."""
    jcfg, tcfg, pj, pt = _attn("mixtral-8x7b")
    ring = jcfg.window
    kv = _rand((2, ring, jcfg.n_kv, jcfg.d_head), 6)
    cj = {"k": jnp.asarray(kv).astype(jnp.bfloat16),
          "v": jnp.asarray(kv[::-1].copy()).astype(jnp.bfloat16)}
    ct = {n: torch.tensor(_np(a)).to(torch.bfloat16) for n, a in cj.items()}
    xj, xt = _pair(_rand((2, 1, jcfg.d_model), 7), "bfloat16")
    p32 = jnp.asarray(pos, jnp.int32)
    yj, new = jax.jit(lambda p, x, c: jtr._decode_rolling(
        p, jcfg, x, c, p32, p32 % ring))(pj, xj, cj)
    yt = ta.attend_rolling(pt, tcfg, xt, ct, pos)
    np.testing.assert_allclose(_np(yt), _np(yj), **LAYER_TOL)
    np.testing.assert_allclose(_np(ct["k"]), _np(new["k"]), **LAYER_TOL)


def test_fill_cache_ring_slots():
    """Prefill puts token ``t`` at slot ``t % ring`` (the ring fix)."""
    k = torch.arange(24, dtype=torch.float32).reshape(1, 24, 1, 1).expand(1, 24, 1, 2)
    for s, ring in ((8, 16), (16, 16), (24, 16), (24, 30)):
        c = {n: torch.full((1, ring, 1, 2), -1.0) for n in ("k", "v")}
        ta.fill_cache(c, k[:, :s], k[:, :s], ring=True)
        want = torch.full((ring,), -1.0)
        for t in range(max(0, s - ring), s):
            want[t % ring] = t
        assert torch.equal(c["k"][0, :, 0, 0], want)


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------


def _moe_case(arch, tokens):
    jcfg, tcfg = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    p = jmoe.init_moe(jax.random.key(1), jcfg)
    xj, xt = _pair(_rand((2, tokens, jcfg.d_model), 8, 0.5), "bfloat16")
    return jcfg, tcfg, p, _load(tmoe.MoE(tcfg), p), xj, xt


@pytest.mark.parametrize("capacity_factor", [None, 0.5, 4.0])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_apply_moe_matches(arch, capacity_factor):
    jcfg, tcfg, pj, pt, xj, xt = _moe_case(arch, 32)
    yj, aj = jax.jit(lambda p, x: jmoe.apply_moe(
        p, jcfg, x, capacity_factor=capacity_factor))(pj, xj)
    yt, at = tmoe.apply_moe(pt, tcfg, xt, capacity_factor=capacity_factor)
    np.testing.assert_allclose(_np(yt), _np(yj), **LAYER_TOL)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(at[name]), float(aj[name]), **LAYER_TOL)
    assert float(at["moe_dropped_frac"]) == float(aj["moe_dropped_frac"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_routing_and_dispatch_grid(arch):
    """Expert ids equal wherever the reference's k-th and (k+1)-th
    probabilities differ by more than ``ROUTE_MARGIN``; on the same ids,
    ``bucket_matrix``'s grid, validity and counts are bit-equal."""
    jcfg, tcfg, pj, pt, xj, xt = _moe_case(arch, 64)
    k, e = jcfg.moe.top_k, jcfg.moe.n_experts
    xn_j = jl.rms_norm(xj, pj["norm"], jcfg.norm_eps).reshape(-1, jcfg.d_model)
    logits = jnp.einsum("td,de->te", xn_j, pj["router"].astype(xn_j.dtype),
                        preferred_element_type=jnp.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    _, top_e_j = jax.lax.top_k(jnp.asarray(probs), k)
    xn_t = tl.rms_norm(xt, pt.norm, tcfg.norm_eps).reshape(-1, tcfg.d_model)
    _, probs_t, _, top_e_t = tmoe.route(pt, tcfg, xn_t)
    np.testing.assert_allclose(probs_t.numpy(), probs, **F32_TOL)
    srt = np.sort(probs, axis=-1)[:, ::-1]
    clear = srt[:, k - 1] - srt[:, k] > ROUTE_MARGIN
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(top_e_t.numpy()[clear], np.asarray(top_e_j)[clear])
    # tie order: lower index first, as lax.top_k
    tied = torch.tensor([[0.25, 0.5, 0.25, 0.0]])
    assert tmoe.top_k(tied, 2)[1].tolist() == [[1, 0]]

    ids = np.asarray(top_e_j).reshape(-1).astype(np.int32)
    for capacity in (8, 40, 128):
        gj, vj, cj = jpart.bucket_matrix(jnp.asarray(ids), e, capacity)
        gt, vt, ct = tpart.bucket_matrix(torch.from_numpy(ids), e, capacity)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
