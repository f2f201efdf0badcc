"""xLSTM blocks (port of ``src/repro/models/xlstm.py``; arXiv:2405.04517):
mLSTM (matrix memory: the stabilised parallel form over a sequence, the
recurrent update with ``(C, n, m, conv)`` state a step) and sLSTM
(scalar memory, a loop over time).

The parallel mLSTM runs one head at a time, as the reference's
``lax.map`` does, so the (B, S, S) decay matrix exists for one head at a
time; masked entries are ``-inf`` before the ``exp``, and every row keeps
its diagonal, so its maximum is finite.  Dtypes are the reference's:
the mLSTM conv window is f32, so q, k and the gates are f32 products of
f32 activations and bf16-rounded weights; v is bf16.  Decode states are
dicts updated in place.  The reference's simplifications are kept: no
sLSTM conv frontend, per-head RMSNorm in place of GroupNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers, recurrence
from repro_torch.models.mamba import _causal_conv

M_INIT = -1e9  # the stabiliser's initial value


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def m_inner(cfg) -> int:
    return 2 * cfg.d_model  # expand factor 2


class MLSTM(nn.Module):
    """One mLSTM sublayer's weights (``init_mlstm``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, di, h = cfg.d_model, m_inner(cfg), cfg.n_heads
        P = layers.param
        self.norm = P((d,), None, device, fill=1.0)
        self.up = P((d, 2 * di), generator, device)
        self.conv_w = P((4, di), generator, device, scale=0.5)
        self.conv_b = P((di,), None, device, fill=0.0)
        self.wq = P((di, di), generator, device)
        self.wk = P((di, di), generator, device)
        self.wv = P((di, di), generator, device)
        self.wi = P((di, h), generator, device)
        self.wf = P((di, h), generator, device)
        self.bi = P((h,), None, device, fill=0.0)
        self.bf = P((h,), None, device, fill=3.0)  # open forget gates at init
        self.out_norm = P((di,), None, device, fill=1.0)
        self.down = P((di, d), generator, device)


def _mlstm_qkvif(p: MLSTM, cfg, xi, conv_state=None):
    b, s, di = xi.shape
    h = cfg.n_heads
    hd = di // h
    dt = xi.dtype
    xc = layers.silu(_causal_conv(xi, p.conv_w, p.conv_b, conv_state))
    q = layers.mm(xc, p.wq.to(dt)).reshape(b, s, h, hd)
    k = layers.mm(xc, p.wk.to(dt)).reshape(b, s, h, hd)
    v = (xi @ p.wv.to(dt)).reshape(b, s, h, hd)
    i_log = layers.mm(xc, p.wi.to(dt)).float() + p.bi
    f_log = layers.mm(xc, p.wf.to(dt)).float() + p.bf
    return q, k, v, i_log, f_log


def _mlstm_parallel(q, k, v, i_log, f_log, out_dtype):
    """The stabilised parallel form, one head at a time -> (B,S,H,hd)."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / (hd**0.5)
    cum = torch.cumsum(layers.log_sigmoid(f_log), dim=1)  # (B,S,H)
    ii = torch.arange(s, device=q.device)
    causal = ii[:, None] >= ii[None, :]
    heads = []
    for hh in range(q.shape[2]):
        cumh, ih = cum[..., hh], i_log[..., hh]
        dmat = cumh[:, :, None] - cumh[:, None, :] + ih[:, None, :]
        dmat = torch.where(causal[None], dmat, -torch.inf)
        m = dmat.amax(dim=2)  # (B,S)
        wdecay = torch.exp(dmat - m[:, :, None])  # (B,S,S)
        qk = torch.einsum("bid,bjd->bij", q[:, :, hh].float(), k[:, :, hh].float()) * scale
        num = torch.einsum("bij,bjd->bid", wdecay * qk, v[:, :, hh].float())
        den = torch.maximum((wdecay * qk).sum(-1).abs(), torch.exp(-m))
        heads.append((num / den[..., None]).to(out_dtype))
    return torch.stack(heads, 2)


def _mlstm_step(q, k, v, i_log, f_log, cache: dict, out_dtype):
    """m' = max(lf + m, i); C' = e^{lf+m-m'} C + e^{i-m'} k v^T, one step;
    updates C, n, m in ``cache`` -> (B,1,H,hd)."""
    scale = 1.0 / (q.shape[3] ** 0.5)
    lf = layers.log_sigmoid(f_log[:, 0])  # (B,H)
    il = i_log[:, 0]
    m_prev = cache["m"]
    m_new = torch.maximum(lf + m_prev, il)
    fdec = torch.exp(lf + m_prev - m_new)[..., None, None]
    iexp = torch.exp(il - m_new)[..., None, None]
    k1, v1, q1 = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
    c_new = fdec * cache["C"] + iexp * torch.einsum("bhd,bhe->bhde", k1, v1)
    n_new = fdec[..., 0] * cache["n"] + iexp[..., 0] * k1
    num = torch.einsum("bhde,bhd->bhe", c_new, q1) * scale
    den = torch.maximum(
        torch.einsum("bhd,bhd->bh", n_new, q1).abs() * scale, torch.exp(-m_new)
    )
    cache.update(C=c_new, n=n_new, m=m_new)
    return (num / den[..., None]).to(out_dtype)[:, None]


def apply_mlstm(p: MLSTM, cfg, x, cache: dict | None = None):
    """Train/prefill (``cache`` None, the parallel form) or one decode step
    (the recurrent form; ``cache`` updated in place)."""
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    di = m_inner(cfg)
    up = xn @ p.up.to(xn.dtype)
    xi, z = up[..., :di], up[..., di:]
    conv_state = None if cache is None else cache["conv"]
    q, k, v, i_log, f_log = _mlstm_qkvif(p, cfg, xi, conv_state)
    if cache is None:
        hcore = _mlstm_parallel(q, k, v, i_log, f_log, x.dtype)
    else:
        hcore = _mlstm_step(q, k, v, i_log, f_log, cache, x.dtype)
        dt = torch.promote_types(conv_state.dtype, xi.dtype)
        cache["conv"] = torch.cat([conv_state.to(dt), xi.to(dt)], 1)[:, 1:]
    hflat = layers.rms_norm(hcore.reshape(*x.shape[:2], di), p.out_norm, cfg.norm_eps)
    return x + (hflat * layers.silu(z)) @ p.down.to(x.dtype)


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    di, h = m_inner(cfg), cfg.n_heads
    hd = di // h
    return {
        "C": torch.zeros((batch, h, hd, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
        "m": torch.full((batch, h), M_INIT, device=device),
        # the causal-conv window, f32 as in the reference (decode sees the
        # taps the parallel form convolves over)
        "conv": torch.zeros((batch, 3, di), device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


class SLSTM(nn.Module):
    """One sLSTM sublayer's weights (``init_slstm``): per gate an input
    weight ``w<g>`` (D, D), a block-diagonal recurrent weight ``r<g>``
    (H, hd, hd) and a bias ``b<g>``."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        P = layers.param
        self.norm = P((d,), None, device, fill=1.0)
        for g in GATES:
            setattr(self, f"w{g}", P((d, d), generator, device))
        for g in GATES:
            setattr(self, f"r{g}", P((h, hd, hd), generator, device, scale=0.5))
        for g in GATES:
            setattr(self, f"b{g}", P((d,), None, device, fill=1.0 if g == "f" else 0.0))
        self.down = P((d, d), generator, device)


def _slstm_cell(p: SLSTM, cfg, xt, state: dict) -> dict:
    """One sLSTM step. xt (B, D); state dict of (B,H,hd) f32."""
    h_, c, n, m = state["h"], state["c"], state["n"], state["m"]
    b, nh = xt.shape[0], cfg.n_heads
    hd = cfg.d_model // nh

    def gate(g):
        wx = (xt @ getattr(p, f"w{g}").to(xt.dtype)).reshape(b, nh, hd).float()
        # the f32 state times the weight, promoted as ``jnp.einsum`` does
        # (the microbatched train step hands bf16 weights)
        rh = torch.einsum("bhd,hde->bhe", h_, getattr(p, f"r{g}").to(h_.dtype))
        return wx + rh + getattr(p, f"b{g}").reshape(nh, hd)[None]

    i_t, f_t, z_t, o_t = (gate(g) for g in GATES)
    m_new = torch.maximum(f_t + m, i_t)
    i_e = torch.exp(i_t - m_new)
    f_e = torch.exp(f_t + m - m_new)
    c_new = f_e * c + i_e * torch.tanh(z_t)
    n_new = f_e * n + i_e
    h_new = layers.sigmoid(o_t) * c_new / torch.clamp_min(n_new, 1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def apply_slstm(p: SLSTM, cfg, x, cache: dict | None = None):
    """A loop over time (``recurrence.scan``) from ``cache`` (updated in
    place) or, if None, from the initial state."""
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    b, s = x.shape[0], x.shape[1]
    state = cache if cache is not None else init_slstm_cache(cfg, b, x.device)

    def step(st, xt):
        st = _slstm_cell(p, cfg, xt, st)
        return st, st["h"]

    state, hs = recurrence.scan(step, state, xn)
    if cache is not None:
        cache.update(state)
    hseq = hs.reshape(b, s, cfg.d_model).to(x.dtype)
    return x + hseq @ p.down.to(x.dtype)


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {
        "h": torch.zeros(shape, device=device),
        "c": torch.zeros(shape, device=device),
        "n": torch.zeros(shape, device=device),
        "m": torch.full(shape, M_INIT, device=device),
    }
