"""GQA attention: qk-norm (qwen3), QKV bias (qwen2), sliding window
(mixtral), bidirectional (whisper encoder), cross-attention (whisper
decoder), and KV-cache decode (port of ``src/repro/models/attention.py``).

The train/prefill path computes scores with ``torch`` matmuls: dense up to
``CHUNK_THRESHOLD`` tokens, blockwise with an online softmax beyond (the
reference's ``lax.scan`` becomes a Python loop over blocks).  Decode writes
one token's K/V into a preallocated ``(B, S_max, K, hd)`` bf16 cache in
place and attends over the whole cache under a mask.  A sliding-window
layer keeps a ring of ``min(max_seq, window)`` slots; token ``t`` lives
in slot ``t % ring``, from prefill on.

On DTensors (a sharded step, ``sharding/spmd.py``) the same code runs
under DTensor's sharding propagation.  A sharded cache is written by a
``local_map`` with shard-local index arithmetic (``_cache_write``, the
reference's ``shard_map`` ``_cache_update``): each sequence shard checks
which of the new tokens fall in its range and writes them locally, so
the write moves no cache bytes.  With ``REPRO_OPT_SHARDING`` the queries'
heads are pinned to the "model" axis, as the reference's constraint
pins them.  The attention products run in a ``local_map`` over batch
shards (and, in opt mode, the query heads over "model" wherever H
divides it, each rank with the kv heads its query heads read: the
reference's constraints on its blocks and carries), where DTensor's
propagation of its batched products fails.  In opt mode the blockwise
attention also takes the reference's opt-mode blocks and bf16
probabilities.  Without a mesh every one of these is the identity.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.sharding import rules, spmd

NEG_INF = -1e9

# memory threshold: use the chunked online-softmax path beyond this length
CHUNK_THRESHOLD = 2048
Q_BLOCK = 512
KV_BLOCK = 1024
# REPRO_OPT_SHARDING: the reference's opt-mode blocks
OPT_Q_BLOCK = 1024
OPT_KV_BLOCK = 2048


class Attention(nn.Module):
    """One attention sublayer's weights (``init_attn``); ``cross`` adds
    the encoder side's norm ``norm_kv``."""

    def __init__(self, cfg, generator: torch.Generator | None = None, device=None,
                 *, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.d_head
        h, k = cfg.n_heads, cfg.n_kv
        P = layers.param
        self.norm = P((d,), None, device, fill=1.0)
        self.wq = P((d, h * hd), generator, device)
        self.wk = P((d, k * hd), generator, device)
        self.wv = P((d, k * hd), generator, device)
        self.wo = P(
            (h * hd, d), generator, device,
            scale=1.0 / max(1, cfg.n_layers) ** 0.5,
        )
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = P((h * hd,), None, device, fill=0.0)
            self.bk = P((k * hd,), None, device, fill=0.0)
            self.bv = P((k * hd,), None, device, fill=0.0)
        self.qk_norm = cfg.qk_norm
        if cfg.qk_norm:
            self.q_norm = P((hd,), None, device, fill=1.0)
            self.k_norm = P((hd,), None, device, fill=1.0)
        if cross:
            self.norm_kv = P((d,), None, device, fill=1.0)


def _project_qkv(p: Attention, cfg, xq: torch.Tensor, xkv: torch.Tensor):
    h, k, hd = cfg.n_heads, cfg.n_kv, cfg.d_head
    dt = xq.dtype
    q = xq @ p.wq.to(dt)
    kk = xkv @ p.wk.to(dt)
    v = xkv @ p.wv.to(dt)
    if p.qkv_bias:
        q = q + p.bq.to(dt)
        kk = kk + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = spmd.split_heads(q, h)
    kk = spmd.split_heads(kk, k)
    v = spmd.split_heads(v, k)
    if p.qk_norm:
        q = layers.rms_norm(q, p.q_norm, cfg.norm_eps)
        kk = layers.rms_norm(kk, p.k_norm, cfg.norm_eps)
    if rules.opt_sharding_enabled():
        q = rules.constrain(q, "B", None, "model", None)
    return q, kk, v


def _sdpa(q, k, v, mask, n_rep: int):
    """q (B,Sq,H,hd), k/v (B,Sk,K,hd), mask (B|1,Sq,Sk) bool (True=keep).
    Scores and softmax in f32; the weights are cast to q's dtype.  On
    DTensors in a ``local_map`` as :func:`_sdpa_chunked` runs (the mask
    then (1,Sq,Sk); a sequence-sharded cache is gathered whole for it)."""
    if spmd.is_dtensor(q):
        return spmd.on_batch_heads(lambda a, b, c, r: _sdpa(a, b, c, mask, r),
                                   q, k, v, n_rep, heads=rules.opt_sharding_enabled())
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, n_rep, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg.float(), k.float()) / (hd**0.5)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, n_rep: int, *, causal: bool = True, window: int = 0):
    """:func:`_blockwise`; on DTensors in a ``local_map`` over the batch
    shards — and, with ``REPRO_OPT_SHARDING``, the query heads over
    "model" where H divides it, each rank with the kv heads its query
    heads read (the reference's opt-mode constraints on the blocks and
    their carries, which repeat kv to H heads block by block): blocks of
    different rows and heads never meet."""
    opt = rules.opt_sharding_enabled()
    if not spmd.is_dtensor(q):
        return _blockwise(q, k, v, n_rep, causal=causal, window=window, opt=opt)
    return spmd.on_batch_heads(
        lambda a, b, c, r: _blockwise(a, b, c, r, causal=causal, window=window, opt=opt),
        q, k, v, n_rep, heads=opt)


def _blockwise(q, k, v, n_rep: int, *, causal: bool = True, window: int = 0,
               opt: bool = False):
    """Flash-style blockwise attention: O(S·block) memory instead of
    O(S²).

    A loop over query blocks, and inside it over kv blocks with an online
    (m, l, acc) softmax; causal/window masks are applied per block pair
    from absolute positions.

    Blocks are the reference's ``Q_BLOCK`` x ``KV_BLOCK``; with ``opt``
    (``REPRO_OPT_SHARDING``) its ``OPT_Q_BLOCK`` x ``OPT_KV_BLOCK``, and
    the probabilities are rounded to and kept in bf16 between the
    softmax and the product, m and l in f32, as its opt mode stores
    them.  Where the blocks do not divide a length, the reference
    halves them until they do (8-token blocks at 2,600 tokens: ~53,000
    block pairs, a Python loop of ~10^6 launches here); the port pads
    the last block instead, in both modes, masks the
    padded keys and drops the padded queries — the same softmax over the
    same keys, summed in other blocks.  A kv block that every query of
    the block masks is skipped: in the reference it contributes exactly
    nothing (a later block's ``corr = exp(-1e9 - m) = 0`` erases one that
    comes first, ``p = exp(-1e9 - m) = 0`` one that comes after).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qb = min(OPT_Q_BLOCK if opt else Q_BLOCK, sq)
    kb = min(OPT_KV_BLOCK if opt else KV_BLOCK, sk)
    kv_len = sk
    if sk % kb:
        pad = k.new_zeros((b, -sk % kb, *k.shape[2:]))
        k, v = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
        sk = k.shape[1]
    scale = 1.0 / (hd**0.5)
    out = q.new_empty((b, -(-sq // qb) * qb, h, hd))
    dev = q.device
    for q0 in range(0, sq, qb):
        qblk = q[:, q0 : q0 + qb].float()
        if qblk.shape[1] < qb:  # the last block, padded
            qblk = torch.cat([qblk, qblk.new_zeros((b, qb - qblk.shape[1], h, hd))], 1)
        q_pos = torch.arange(q0, q0 + qb, device=dev)
        m_run = torch.full((b, h, qb), -torch.inf, device=dev)
        l_run = torch.zeros((b, h, qb), device=dev)
        acc = torch.zeros((b, h, qb, hd), device=dev)
        for k0 in range(0, sk, kb):
            if causal and k0 > q0 + qb - 1:
                break
            if window > 0 and k0 + kb - 1 <= q0 - window:
                continue
            # GQA: expand kv heads to H at block granularity (kb x H x hd)
            kr = k[:, k0 : k0 + kb].repeat_interleave(n_rep, dim=2)
            vr = v[:, k0 : k0 + kb].repeat_interleave(n_rep, dim=2)
            k_pos = torch.arange(k0, k0 + kb, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kr.float()) * scale
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            if sk > kv_len:
                mask &= k_pos[None, :] < kv_len
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            if opt:
                p = p.to(torch.bfloat16)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vr.dtype).float(), vr.float()
            )
            m_run = m_new
        blk = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        out[:, q0 : q0 + qb] = blk.transpose(1, 2).to(q.dtype)
    return out[:, :sq]


def _attend_out(p: Attention, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    flat = out.reshape(*out.shape[:2], -1)
    return x + flat @ p.wo.to(x.dtype)


def _rope(cfg, q, k, positions):
    if cfg.rope_theta > 0:
        cos, sin = layers.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    return q, k


def attend_full(
    p: Attention,
    cfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    return_kv: bool = False,
):
    """Train / prefill self-attention over the whole sequence; causal
    unless ``causal=False`` (whisper's encoder)."""
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, xn, xn)
    q, k = _rope(cfg, q, k, positions)
    s = x.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv
    if s > CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, k, v, n_rep, causal=causal, window=window)
    else:
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = j <= i if causal else torch.ones((s, s), dtype=torch.bool, device=x.device)
        if window > 0:
            mask = mask & (j > i - window)
        out = _sdpa(q, k, v, mask[None], n_rep)
    y = _attend_out(p, x, out)
    if return_kv:
        return y, (k, v)
    return y


def init_cache(cfg, batch: int, max_seq: int, dtype=layers.COMPUTE_DTYPE, device=None):
    kv, hd = cfg.n_kv, cfg.d_head
    return {
        "k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
    }


def _cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor, runs) -> bool:
    """Write the rows of ``k``/``v`` (B, n, K, hd) into a DTensor cache and
    return True (False for a plain cache, which the caller writes
    itself).  ``runs`` lists ``(row, slot, length)``: rows
    ``row..row+length-1`` go to slots ``slot..``.  A ``local_map`` over
    the cache's own layout: the new rows follow the cache's batch
    sharding (replicated elsewhere), and each sequence shard writes the
    slots in its range at shard-local positions (``local = slot - shard
    * s_loc``, kept where ``0 <= local < s_loc``), in place."""
    if not spmd.is_dtensor(cache["k"]):
        return False
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ck = cache["k"]
    mesh, pl = ck.device_mesh, tuple(ck.placements)
    npl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    seq_dims = [i for i, p in enumerate(pl) if p == Shard(1)]

    def local(ck, cv, kn, vn):
        # flat shard index along the sharded seq axes, in mesh order
        coord, idx = mesh.get_coordinate(), 0
        for i in seq_dims:
            idx = idx * mesh.size(i) + coord[i]
        s_loc = ck.shape[1]
        for row, slot, n in runs:
            lo = max(slot, idx * s_loc)
            hi = min(slot + n, (idx + 1) * s_loc)
            if lo < hi:  # in_range
                src = slice(row + lo - slot, row + hi - slot)
                dst = slice(lo - idx * s_loc, hi - idx * s_loc)
                ck[:, dst] = kn[:, src].to(ck.dtype)
                cv[:, dst] = vn[:, src].to(cv.dtype)
        return ck, cv

    cache["k"], cache["v"] = local_map(
        local, out_placements=(list(pl), list(pl)), in_placements=(pl, pl, npl, npl),
        device_mesh=mesh, redistribute_inputs=True,
    )(ck, cache["v"], k, v)
    return True


def _decode_qkv(p: Attention, cfg, x: torch.Tensor, pos: int):
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, cfg, xn, xn)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    return (*_rope(cfg, q, k_new, posv), v_new)


def attend_decode(p: Attention, cfg, x, cache: dict, pos: int):
    """One-token decode: write the cache at ``pos`` in place, attend over
    the prefix.  x (B,1,D); pos — current write index (same for the batch).
    (The reference's ``window=`` is not ported: a sliding-window layer
    decodes through ``attend_rolling``.)"""
    s_max = cache["k"].shape[1]
    if pos >= s_max:
        raise ValueError(f"decode position {pos} is past the cache's {s_max} slots")
    q, k_new, v_new = _decode_qkv(p, cfg, x, pos)
    if not _cache_write(cache, k_new, v_new, [(0, pos, 1)]):
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    mask = torch.arange(s_max, device=x.device)[None, :] <= pos
    out = _sdpa(
        q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask[:, None, :],
        cfg.n_heads // cfg.n_kv,
    )
    return _attend_out(p, x, out)


def attend_rolling(p: Attention, cfg, x, cache: dict, pos: int):
    """Sliding-window decode over a ring of ``min(max_seq, window)`` slots:
    token ``pos`` is written at slot ``pos % ring`` in place.

    RoPE is applied at write time with absolute positions, so attention
    over the (order-rotated) ring is position-correct.  Slots
    ``0..min(pos, ring-1)`` hold tokens; once ``pos >= ring`` the ring
    holds exactly the last ``window`` tokens.  A ring shorter than the
    window (``max_seq < window``) has no slot to evict into and raises."""
    ring = cache["k"].shape[1]
    if ring < cfg.window and pos >= ring:
        raise ValueError(f"decode position {pos} is past the cache's {ring} slots")
    q, k_new, v_new = _decode_qkv(p, cfg, x, pos)
    slot = pos % ring
    if not _cache_write(cache, k_new, v_new, [(0, slot, 1)]):
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    written = torch.arange(ring, device=x.device)[None, :] <= min(pos, ring - 1)
    mask = written | (pos >= ring)
    out = _sdpa(
        q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask[:, None, :],
        cfg.n_heads // cfg.n_kv,
    )
    return _attend_out(p, x, out)


def fill_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, *, ring: bool) -> None:
    """Write a prompt's K/V (B, S, K, hd) into a cache in place: at slots
    ``0..S-1``, or, for a ring, the last ``ring`` tokens at ``t % ring``."""
    s, n = k.shape[1], cache["k"].shape[1]
    if not ring:
        if s > n:
            raise ValueError(f"a prompt of {s} tokens does not fit {n} cache slots")
        if not _cache_write(cache, k, v, [(0, 0, s)]):
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
        return
    first = max(0, s - n)
    # tokens first..s-1 at slots t % n: at most two runs of slots
    wrap = min(s, (first // n + 1) * n)
    runs = [(first, first % n, wrap - first), (wrap, 0, s - wrap)]
    if _cache_write(cache, k, v, [r for r in runs if r[2] > 0]):
        return
    slots = torch.arange(first, s, device=k.device) % n
    cache["k"][:, slots] = k[:, first:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, first:].to(cache["v"].dtype)


def attend_cross(p: Attention, cfg, x, kv_cache: dict):
    """Cross-attention against precomputed encoder K/V (whisper decoder);
    blockwise above ``CHUNK_THRESHOLD`` queries, where ``_sdpa_chunked``
    pads the kv to a block multiple and masks the padding."""
    x = spmd.batch_layout(x)
    xn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    dt = x.dtype
    q = spmd.split_heads(xn @ p.wq.to(dt), cfg.n_heads)
    k, v = kv_cache["k"].to(dt), kv_cache["v"].to(dt)
    n_rep = cfg.n_heads // cfg.n_kv
    if x.shape[1] > CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, k, v, n_rep, causal=False)
    else:
        mask = torch.ones((x.shape[1], k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask[None], n_rep)
    return _attend_out(p, x, out)


def encode_cross_kv(p: Attention, cfg, enc_out) -> dict:
    """A decoder layer's cross K/V from the encoder's output."""
    xn = layers.rms_norm(enc_out, p.norm_kv, cfg.norm_eps)
    dt = enc_out.dtype
    return {"k": spmd.split_heads(xn @ p.wk.to(dt), cfg.n_kv),
            "v": spmd.split_heads(xn @ p.wv.to(dt), cfg.n_kv)}
