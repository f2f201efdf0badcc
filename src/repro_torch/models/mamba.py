"""Mamba (S6) block for the Jamba hybrid (port of
``src/repro/models/mamba.py``; arXiv:2312.00752 / 2403.19887).

The full-sequence path is the reference's chunked selective scan: within
a chunk of ``CHUNK`` steps the recurrence runs as an associative scan
(``_chunk_scan``, the odd/even recursion of ``jax.lax.associative_scan``,
log2(CHUNK) levels of whole-chunk ops); across chunks a Python loop
carries the (B, Di, N) state.  The chunk's gate tensors (B, CHUNK, Di, N)
are built inside the loop, and the padded steps of the last chunk are
the recurrence's identity (da = 1, db = 0), as in the reference.  Decode
is the O(1) single-step update of a ``{"conv", "ssm"}`` cache, updated in
place.

Dtypes are the reference's: the conv multiplies bf16 activations by f32
taps, so everything from the conv on (the scan included) runs in f32
until ``y`` is cast back to the activation dtype.

The conv tail differs from the reference's on purpose: the reference
keeps ``xi[:, -(d_conv-1):]``, only P rows long for a prompt of
P < d_conv - 1 tokens, and its next decode step then fails on the
4-tap product.  Here the tail is always (B, d_conv-1, Di), left-padded
with zeros — the zeros the full-sequence conv sees before the first
token (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers

CHUNK = 256


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


class Mamba(nn.Module):
    """One Mamba sublayer's weights (``init_mamba``)."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None):
        super().__init__()
        d, di = cfg.d_model, d_inner(cfg)
        n, r, dc = cfg.mamba.d_state, dt_rank(cfg), cfg.mamba.d_conv
        P = layers.param
        self.norm = P((d,), None, device, fill=1.0)
        self.in_proj = P((d, 2 * di), generator, device)
        self.conv_w = P((dc, di), generator, device, scale=0.5)
        self.conv_b = P((di,), None, device, fill=0.0)
        self.x_proj = P((di, r + 2 * n), generator, device)
        self.dt_proj = P((r, di), generator, device)
        self.dt_bias = P((di,), None, device)
        self.A_log = P((di, n), None, device)
        self.D = P((di,), None, device, fill=1.0)
        self.out_proj = P((di, d), generator, device)
        if generator is not None:
            # softplus^-1 of dt ~ U(1e-3, 1e-1); S4-style A = -(1..N) a channel
            u = torch.rand(di, generator=generator, device=device)
            self.dt_bias.copy_(torch.log(torch.expm1(u * (1e-1 - 1e-3) + 1e-3)))
            a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
            self.A_log.copy_(torch.log(a).expand(di, n))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along S via shifted adds (d_conv taps).

    x (B,S,Di); w (dc,Di).  Without ``state`` the taps before the first
    step are zeros; with ``state`` (B, dc-1, Di) they come from it.  The
    sum is in the promoted dtype of x, w and the state (f32 for bf16
    activations), tap by tap in the reference's order."""
    dc, s = w.shape[0], x.shape[1]
    if state is None:
        src = torch.cat([x.new_zeros((x.shape[0], dc - 1, x.shape[2])), x], 1)
    else:
        dt = torch.promote_types(state.dtype, x.dtype)
        src = torch.cat([state.to(dt), x.to(dt)], 1)
    out = x * w[-1][None, None, :]
    for tap in range(1, dc):
        out = out + src[:, dc - 1 - tap : dc - 1 - tap + s] * w[-1 - tap][None, None, :]
    return out + b[None, None, :]


def _ssm_inputs(p: Mamba, cfg, xc):
    """Common projections: (da (B,S,Di,N) decay, db (B,S,Di,N) input,
    c (B,S,N), d_skip), all f32."""
    n, r = cfg.mamba.d_state, dt_rank(cfg)
    dt_bcn = xc @ p.x_proj.to(xc.dtype)
    dt_r, b_ssm, c_ssm = dt_bcn[..., :r], dt_bcn[..., r : r + n], dt_bcn[..., r + n :]
    dt = layers.softplus(
        (dt_r @ p.dt_proj.to(xc.dtype)).float() + p.dt_bias[None, None, :]
    )  # (B,S,Di)
    a = -torch.exp(p.A_log)  # (Di,N)
    da = torch.exp(dt[..., None] * a[None, None])  # decay in (0,1]
    db = (dt * xc.float())[..., None] * b_ssm.float()[:, :, None, :]
    return da, db, c_ssm.float(), p.D


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


def _interleave(a, b):
    """``a`` at the even steps, ``b`` at the odd ones (axis 1)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1], *a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _chunk_scan(da, db):
    """h_t = da_t * h_{t-1} + db_t from h_{-1} = 0, along axis 1, as
    ``jax.lax.associative_scan`` combines: pairs reduced, the half-length
    scan recursed, the even steps filled in."""
    n = da.shape[1]
    if n < 2:
        return da, db
    odd = _chunk_scan(*_combine((da[:, 0:-1:2], db[:, 0:-1:2]),
                                (da[:, 1::2], db[:, 1::2])))
    prev = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(prev, (da[:, 2::2], db[:, 2::2]))
    return tuple(
        _interleave(torch.cat([e[:, :1], r], 1), o)
        for e, r, o in zip((da, db), even, odd)
    )


def apply_mamba(p: Mamba, cfg, x, cache: dict | None = None, *,
                return_state: bool = False):
    """Full sequence if ``cache`` is None (returns x, or (x, state) with
    ``return_state``, the state ``{"conv": (B, dc-1, Di), "ssm":
    (B, Di, N) f32}`` prefill leaves); else one decode step that updates
    ``cache`` in place (returns x)."""
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    di = d_inner(cfg)
    xz = xn @ p.in_proj.to(xn.dtype)
    xi, z = xz[..., :di], xz[..., di:]

    if cache is None:
        xc = layers.silu(_causal_conv(xi, p.conv_w, p.conv_b))
        b, s = x.shape[0], x.shape[1]
        pad = (-s) % CHUNK
        if pad:
            xc_p = torch.cat([xc, xc.new_zeros((b, pad, di))], 1)
        else:
            xc_p = xc
        h = torch.zeros((b, di, cfg.mamba.d_state), device=x.device)
        ys = []
        for c0 in range(0, s + pad, CHUNK):
            xck = xc_p[:, c0 : c0 + CHUNK]
            da, db, c, d_skip = _ssm_inputs(p, cfg, xck)
            if c0 + CHUNK > s:  # padded steps: the recurrence's identity
                m = (torch.arange(c0, c0 + CHUNK, device=x.device) < s)[None, :, None, None]
                da = torch.where(m, da, 1.0)
                db = torch.where(m, db, 0.0)
            acc_a, acc_b = _chunk_scan(da, db)
            hs = acc_a * h[:, None] + acc_b  # inject the carry
            y = torch.einsum("bsdn,bsn->bsd", hs, c) + d_skip[None, None] * xck.float()
            h = hs[:, -1]
            ys.append(y.to(x.dtype))
        y = torch.cat(ys, 1)[:, :s]
        state = None
        if return_state:
            dc = cfg.mamba.d_conv
            tail = xi[:, -(dc - 1):]
            if tail.shape[1] < dc - 1:  # zeros before the first token
                tail = torch.cat([tail.new_zeros(
                    (b, dc - 1 - tail.shape[1], di)), tail], 1)
            state = {"conv": tail, "ssm": h}
    else:
        conv = cache["conv"]
        dt = torch.promote_types(conv.dtype, xi.dtype)
        conv_in = torch.cat([conv.to(dt), xi.to(dt)], 1)  # (B, dc, Di)
        w = p.conv_w.to(xi.dtype)
        wdt = torch.promote_types(dt, w.dtype)
        acc = torch.einsum("btd,td->bd", conv_in.to(wdt).float(), w.to(wdt).float())
        xc = layers.silu(acc.to(wdt) + p.conv_b[None, :])[:, None, :]
        da, db, c, d_skip = _ssm_inputs(p, cfg, xc)
        h = da[:, 0] * cache["ssm"] + db[:, 0]  # (B,Di,N)
        y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None] + d_skip[None, None] * xc.float()
        cache["conv"] = conv_in[:, 1:]
        cache["ssm"] = h
        state = None

    out = y.to(x.dtype) * layers.silu(z)
    out = x + out @ p.out_proj.to(x.dtype)
    return (out, state) if return_state else out


def init_mamba_cache(cfg, batch: int, dtype=layers.COMPUTE_DTYPE, device=None):
    di = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba.d_state), device=device),
    }
