"""Port parity of the recurrent sublayers: ``repro_torch.models.{mamba,
xlstm}`` against ``repro.models``'s on the same numpy inputs and the
same parameters (the reference's ``jax.random`` init loaded into the
port's modules), and each parallel or chunked form against the port's
own step-by-step recurrence, as ``tests/test_recurrent_parity.py`` holds
the reference's.  Also the short-prompt Mamba conv cache, which the port
fixes and the reference gets wrong (ROADMAP Queue 3): the port's
prefill-then-decode against its own ``forward`` on its own seeded
parameters, and the reference's ``apply_mamba`` raising where the port
serves.

The reference runs op by op (``jax.disable_jit()``), every op rounded to
the dtype its source names, as the port rounds.  Activations are bf16,
as on the serving path.

Tolerances: results against the reference ``TOL`` (atol = rtol = 5e-2,
``tests/test_torch_lm_serve.py``'s); the port's parallel against its
recurrent form on f32 inputs at the reference's own tolerances
(``tests/test_recurrent_parity.py``); decoded tokens equal to
``forward``'s argmax wherever its top-2 logit gap exceeds
``TOKEN_MARGIN`` = twice ``TOL``, except where a decode step routed to
other MoE experts than ``forward`` at a router near-tie (probabilities
within ``ROUTE_MARGIN``).
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import mamba as jm, xlstm as jx  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import mamba as tm, transformer as ttr  # noqa: E402
from repro_torch.models import moe as tmoe, xlstm as tx  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

TOL = dict(atol=5e-2, rtol=5e-2)
TOKEN_MARGIN = 2 * TOL["atol"]
ROUTE_MARGIN = 0.01  # chip_smoke.py's LM_ROUTE_MARGIN
B, T = 2, 6  # batch, decode steps


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str = "bfloat16"):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                            for k, v in jax.device_get(tree).items()})
    return module


def _x(s: int, d: int, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((B, s, d)) * 0.5).astype(np.float32)


def _assert_state(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_allclose(_np(got[name]), _np(w), **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# Mamba (jamba smoke: d 64, Di 128, N 4, d_conv 4)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg = jreg.get_config("jamba-v0.1-52b", smoke=True)
    tcfg = treg.get_config("jamba-v0.1-52b", smoke=True)
    jp = jm.init_mamba(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _load(tm.Mamba(tcfg), jp)


@pytest.mark.parametrize("s", [5, tm.CHUNK, tm.CHUNK + 7])
def test_apply_mamba_matches_reference(mamba_pair, s):
    """The three paths against the reference's, below, at and across the
    chunk boundary: the full-sequence output, ``return_state``'s state,
    then ``T`` decode steps from that state (outputs and cache)."""
    jcfg, tcfg, jp, tp = mamba_pair
    xj, xt = _pair(_x(s, jcfg.d_model))
    assert tm.CHUNK == jm.CHUNK
    with jax.disable_jit():
        yj = jm.apply_mamba(jp, jcfg, xj)[0]
        yj2, state_j = jm.apply_mamba(jp, jcfg, xj, return_state=True)
    yt = tm.apply_mamba(tp, tcfg, xt)
    yt2, state_t = tm.apply_mamba(tp, tcfg, xt, return_state=True)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    assert torch.equal(yt2, yt)
    _assert_state(state_t, state_j)
    steps = _x(T, jcfg.d_model, seed=2)
    for t in range(T):
        sj, st = _pair(steps[:, t : t + 1])
        with jax.disable_jit():
            yj, state_j = jm.apply_mamba(jp, jcfg, sj, cache=state_j)
        yt = tm.apply_mamba(tp, tcfg, st, cache=state_t)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    _assert_state(state_t, state_j)


def test_mamba_parallel_vs_recurrent(mamba_pair):
    """The chunked scan against 12 single steps from a zero f32 cache:
    outputs and the final state (the reference's test and tolerance)."""
    _, cfg, _, p = mamba_pair
    x = torch.from_numpy(_x(12, cfg.d_model))
    y_par, state = tm.apply_mamba(p, cfg, x, return_state=True)
    cache = tm.init_mamba_cache(cfg, B, dtype=torch.float32)
    y_seq = torch.cat([tm.apply_mamba(p, cfg, x[:, t : t + 1], cache) for t in range(12)], 1)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(state["ssm"].numpy(), cache["ssm"].numpy(),
                               atol=2e-3, rtol=2e-2)
    assert torch.equal(state["conv"], cache["conv"])


def test_chunk_scan_is_the_recurrence():
    """``_chunk_scan`` at every length 1..9 and a chunk: h_t = da_t h_{t-1}
    + db_t, step by step in f64."""
    rng = np.random.default_rng(0)
    for n in [*range(1, 10), tm.CHUNK]:
        da = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3))).double()
        db = torch.from_numpy(rng.standard_normal((2, n, 3)))
        acc_a, acc_b = tm._chunk_scan(da, db)
        h, a = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
        for t in range(n):
            h, a = da[:, t] * h + db[:, t], a * da[:, t]
            torch.testing.assert_close(acc_b[:, t], h)
            torch.testing.assert_close(acc_a[:, t], a)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM (xlstm smoke: d 64, 4 heads)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xlstm_cfgs():
    return (jreg.get_config("xlstm-350m", smoke=True),
            treg.get_config("xlstm-350m", smoke=True))


def _steps(fn, p, cfg, x, cache):
    return torch.cat([fn(p, cfg, x[:, t : t + 1], cache) for t in range(x.shape[1])], 1)


def test_mlstm_matches_reference(xlstm_cfgs):
    """The parallel form over 10 steps, then the recurrent form over the
    same 10 from the initial cache (outputs and ``C, n, m, conv``)."""
    jcfg, tcfg = xlstm_cfgs
    jp = jx.init_mlstm(jax.random.PRNGKey(0), jcfg)
    tp = _load(tx.MLSTM(tcfg), jp)
    xj, xt = _pair(_x(10, jcfg.d_model))
    with jax.disable_jit():
        yj = jx.apply_mlstm(jp, jcfg, xj)[0]
        cache_j, ys = jx.init_mlstm_cache(jcfg, B), []
        for t in range(10):
            y, cache_j = jx.apply_mlstm(jp, jcfg, xj[:, t : t + 1], cache=cache_j)
            ys.append(y)
    yt = tx.apply_mlstm(tp, tcfg, xt)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    cache_t = tx.init_mlstm_cache(tcfg, B)
    _assert_state(cache_t, jx.init_mlstm_cache(jcfg, B))
    np.testing.assert_allclose(_np(_steps(tx.apply_mlstm, tp, tcfg, xt, cache_t)),
                               _np(jnp.concatenate(ys, 1)), **TOL)
    _assert_state(cache_t, cache_j)


def test_mlstm_parallel_vs_recurrent(xlstm_cfgs):
    _, cfg = xlstm_cfgs
    p = tx.MLSTM(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(10, cfg.d_model))
    y_par = tx.apply_mlstm(p, cfg, x)
    y_seq = _steps(tx.apply_mlstm, p, cfg, x, tx.init_mlstm_cache(cfg, B))
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), atol=5e-3, rtol=5e-2)


def test_slstm_matches_reference(xlstm_cfgs):
    """The loop over 8 steps, then single steps from the initial cache
    (outputs and ``h, c, n, m``)."""
    jcfg, tcfg = xlstm_cfgs
    jp = jx.init_slstm(jax.random.PRNGKey(0), jcfg)
    tp = _load(tx.SLSTM(tcfg), jp)
    xj, xt = _pair(_x(8, jcfg.d_model))
    with jax.disable_jit():
        yj = jx.apply_slstm(jp, jcfg, xj)[0]
        cache_j, ys = jx.init_slstm_cache(jcfg, B), []
        for t in range(8):
            y, cache_j = jx.apply_slstm(jp, jcfg, xj[:, t : t + 1], cache=cache_j)
            ys.append(y)
    yt = tx.apply_slstm(tp, tcfg, xt)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    cache_t = tx.init_slstm_cache(tcfg, B)
    np.testing.assert_allclose(_np(_steps(tx.apply_slstm, tp, tcfg, xt, cache_t)),
                               _np(jnp.concatenate(ys, 1)), **TOL)
    _assert_state(cache_t, cache_j)


def test_slstm_loop_vs_step(xlstm_cfgs):
    _, cfg = xlstm_cfgs
    p = tx.SLSTM(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(8, cfg.d_model))
    y_loop = tx.apply_slstm(p, cfg, x)
    y_step = _steps(tx.apply_slstm, p, cfg, x, tx.init_slstm_cache(cfg, B))
    np.testing.assert_allclose(y_loop.numpy(), y_step.numpy(), atol=2e-3, rtol=2e-2)


def test_sigmoid_is_the_reference_in_f32():
    """``jax.nn.sigmoid`` lowers to ``1 / (1 + exp(-x))`` in f32 as in
    bf16 (sLSTM's output gate); the port's ``layers.sigmoid`` spells it
    the same way, within an f32 ulp of the reference's op by op."""
    from repro_torch.models import layers

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 8
    with jax.disable_jit():
        want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(layers.sigmoid(torch.from_numpy(x)).numpy(), want,
                               rtol=2 ** -22, atol=0)


# ---------------------------------------------------------------------------
# the short-prompt Mamba conv cache (jamba smoke: d_conv 4)
# ---------------------------------------------------------------------------


def _no_drop(cfg):
    """Capacity n_experts / top_k: forward drops no MoE token (decode's 4.0
    drops none at this batch), so only the cache can differ."""
    m = cfg.moe
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))


@pytest.fixture(scope="module")
def jamba():
    cfg = _no_drop(treg.get_config("jamba-v0.1-52b", smoke=True))
    return cfg, build_model(cfg).init_params(seed=0, device="cpu")


def _tokens(cfg, p: int) -> np.ndarray:
    return np.random.default_rng(p).integers(0, cfg.vocab_raw, (B, p + T)).astype(np.int32)


@contextlib.contextmanager
def _recorded_routes():
    """Keep the expert ids and router probabilities of every MoE routing
    call, in call order."""
    calls, route = [], tmoe.route

    def recorded(p, cfg, xn):
        out = route(p, cfg, xn)
        calls.append((out[3], out[1]))
        return out

    tmoe.route = recorded
    try:
        yield calls
    finally:
        tmoe.route = route


def _flipped(dec_routes, fwd_routes, n_moe: int, p: int) -> np.ndarray:
    """(B, T) positions whose decode picked other experts than ``forward``
    in some layer; each must sit at a router near-tie (the k-th and
    (k+1)-th probabilities within ``ROUTE_MARGIN``)."""
    flipped = np.zeros((B, T), bool)
    for j in range(T - 1):
        for layer in range(n_moe):
            ids = dec_routes[n_moe + j * n_moe + layer][0].reshape(B, -1)
            f_ids, f_probs = fwd_routes[layer]
            for row in range(B):
                t = row * (p + T) + p + j
                if set(ids[row].tolist()) != set(f_ids[t].tolist()):
                    srt = f_probs[t].sort(descending=True).values
                    k = ids.shape[1]
                    assert float(srt[k - 1] - srt[k]) < ROUTE_MARGIN
                    flipped[row, j + 1] = True
    return flipped


def _teacher_forced_port(tcfg, tparams, toks, p):
    """Prefill ``p`` tokens, then decode the next ``T`` fed the rest."""
    tm_ = build_model(tcfg)
    last, cache = tm_.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :p])},
                              max_seq=p + T)
    for slot, c in cache.layers[0].items():
        if slot.endswith("mamba"):
            assert tuple(c["conv"].shape) == (B, tcfg.mamba.d_conv - 1, tm.d_inner(tcfg))
    out = [last[:, None]]
    for j in range(T - 1):
        out.append(tm_.decode_logits(tparams, cache, torch.from_numpy(toks[:, p + j : p + j + 1])))
    return torch.cat(out, 1).numpy()


def _clear(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > TOKEN_MARGIN


@pytest.mark.parametrize("p", [1, 2, 3, 8])
def test_short_prompt_decode_matches_forward(jamba, p):
    """At any prompt length, below ``d_conv - 1`` too, the port's
    prefill-then-decode picks its own ``forward``'s argmax at every clear
    position; the conv tail is (B, d_conv-1, Di), zero-left-padded.  A
    position whose decode routed to other experts than ``forward`` (at a
    router near-tie) is left out."""
    cfg, params = jamba
    toks = _tokens(cfg, p)
    with _recorded_routes() as dec_routes:
        served = _teacher_forced_port(cfg, params, toks, p)
    with _recorded_routes() as fwd_routes:
        fwd = ttr.forward(cfg, params, torch.from_numpy(toks))[0].numpy()[:, p - 1 : p - 1 + T]
    n_moe = sum(k == "moe" for period in params.periods for k in period)
    assert np.isfinite(served).all()
    clear = _clear(fwd) & ~_flipped(dec_routes, fwd_routes, n_moe, p)
    assert clear.mean() > 0.5, "too few clear positions to compare"
    np.testing.assert_array_equal(served.argmax(-1)[clear], fwd.argmax(-1)[clear])


@pytest.mark.parametrize("p", [1, 2, 3])
def test_reference_short_prompt_fault(mamba_pair, p):
    """Pins the reference's fault (ROADMAP Queue 3): its prefill keeps the
    conv tail ``xi[:, -(d_conv-1):]``, only P rows for P < d_conv - 1, and
    its next decode step's 4-tap product raises; at P = 3 its decode
    steps agree with the port's, whose tail is always d_conv - 1 rows."""
    jcfg, tcfg, jp, tp = mamba_pair
    x = _x(p + T, jcfg.d_model)
    xj, xt = _pair(x)
    with jax.disable_jit():
        _, state_j = jm.apply_mamba(jp, jcfg, xj[:, :p], return_state=True)
    _, state_t = tm.apply_mamba(tp, tcfg, xt[:, :p], return_state=True)
    dc = jcfg.mamba.d_conv
    assert state_j["conv"].shape[1] == min(p, dc - 1)
    assert state_t["conv"].shape[1] == dc - 1
    torch.testing.assert_close(state_t["conv"][:, dc - 1 - min(p, dc - 1):],
                               torch.from_numpy(_np(state_j["conv"])).bfloat16())
    if p < dc - 1:
        with jax.disable_jit(), pytest.raises(ValueError, match="label 't'"):
            jm.apply_mamba(jp, jcfg, xj[:, p : p + 1], cache=state_j)
        return
    for t in range(p, p + T):
        with jax.disable_jit():
            yj, state_j = jm.apply_mamba(jp, jcfg, xj[:, t : t + 1], cache=state_j)
        yt = tm.apply_mamba(tp, tcfg, xt[:, t : t + 1], cache=state_t)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    _assert_state(state_t, state_j)
