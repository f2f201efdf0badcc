"""The sharded step's plumbing over DTensor: parameters, batches and
caches laid out by ``rules``, and the ``local_map`` regions where DTensor
has no sharding strategy for an op.

The reference runs one GSPMD program: arrays carry ``NamedSharding``s and
the compiler inserts the collectives.  The port's counterpart is DTensor
(``torch.distributed.tensor``): the parameters are DTensors laid out by
``rules.param_specs``, the batch by ``rules.data_spec``, and the model's
own code runs on them unchanged under ``implicit_replication`` (a plain
tensor it makes — a mask, positions — counts as replicated); DTensor's
sharding propagation inserts the all-gathers, reductions and
reduce-scatters.  Ops without a sharding strategy run in ``local_map``
regions: on replicated inputs (:func:`on_replicas`), the MoE's
sort-based dispatch (``core.partition.bucket_matrix``: its count by
the histogram kernel, its scatters) and the index-adds of its combine
and load fraction;
on each rank's rows of the batch (:func:`batch_local`,
:func:`on_batch_heads`, :func:`gather_rows`), the recurrent sublayers
(Mamba's chunk scan, the xLSTM loops), the attention products (their
batched matmuls over a flattened batch x head dim) and the embedding
lookup.  The attention cache writes are ``local_map``s too, with
shard-local index arithmetic (``models/attention.py``).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.sharding import rules


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def mesh_of(x):
    """A DTensor's ``DeviceMesh``; ``None`` for a plain tensor."""
    return x.device_mesh if is_dtensor(x) else None


def replicate(mesh) -> tuple:
    return tuple(Replicate() for _ in range(mesh.ndim))


def on_replicas(fn, n_out: int, *args):
    """``fn(*args)``; where an argument is a DTensor, ``fn`` runs in a
    ``local_map`` on every DTensor argument gathered whole (replicated)
    and returns ``n_out`` replicated DTensors.  Plain tensors pass as
    they are."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)

    mesh = dts[0].device_mesh
    rep = replicate(mesh)
    in_pl = tuple(rep if is_dtensor(a) else None for a in args)
    # one output takes a list (a tuple would read as one entry an output)
    out_pl = list(rep) if n_out == 1 else tuple(list(rep) for _ in range(n_out))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def batch_placements(mesh, batch: int) -> tuple:
    """The batch layout the rules give activations: dim 0 over every
    batch axis where ``batch`` divides their product, replicated over
    "model".  An axis of size 1 holds the whole batch on its one rank, as
    a ``NamedSharding`` over it does, so it is ``Replicate()``: DTensor
    cannot view a ``Shard``ed dim of size 1, even over one rank."""
    names = mesh.mesh_dim_names
    n = math.prod(mesh.size(i) for i, a in enumerate(names) if a != "model")
    split = batch % n == 0
    return tuple(Shard(0) if a != "model" and split and mesh.size(i) > 1 else Replicate()
                 for i, a in enumerate(names))


def _summed_over_batch(bpl: tuple) -> tuple:
    """The gradient layout of a replicated input used on the batch shards
    of ``bpl``: a partial sum over those axes."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in bpl)


def _dtensor(t, mesh):
    """``t`` as a DTensor: a plain tensor counts as replicated."""
    return t if is_dtensor(t) else DTensor.from_local(t, mesh, replicate(mesh),
                                                      run_check=False)


def on_batch_heads(fn, q, k, v, n_rep: int, *, heads: bool):
    """``fn(q, k, v, n_rep)`` for attention tensors (B, S, H | K, hd) in
    a ``local_map``: the batch over the batch axes where it divides them,
    and with ``heads`` q's heads over "model" where H divides it;
    everything else replicated.  k and v's heads go over "model" beside
    q's where K divides it too; where it does not, each rank keeps them
    whole and hands ``fn`` the kv heads its own q heads read
    (:func:`_own_kv_heads`), so that no rank computes another's heads;
    their gradients are then each rank's share of the sum over "model"
    (a partial sum there, which DTensor reduces).  The output has ``q``'s
    layout."""
    mesh = q.device_mesh
    pl = list(batch_placements(mesh, q.shape[0]))
    kv_pl = list(pl)
    own = None
    if heads and "model" in mesh.mesh_dim_names:
        i = mesh.mesh_dim_names.index("model")
        m = mesh.size(i)
        if q.shape[2] % m == 0:
            pl[i] = Shard(2)
            if k.shape[2] % m == 0:
                kv_pl[i] = Shard(2)
            else:
                own = i
    kv_grad = tuple(Partial() if j == own else p for j, p in enumerate(kv_pl))
    pl, kv_pl = tuple(pl), tuple(kv_pl)

    def local(ql, kl, vl):
        if own is None:
            return fn(ql, kl, vl, n_rep)
        return fn(ql, *_own_kv_heads(kl, vl, ql.shape[2], mesh.get_coordinate()[own], n_rep))

    return local_map(local, out_placements=list(pl), in_placements=(pl, kv_pl, kv_pl),
                     in_grad_placements=(pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, _dtensor(k, mesh), _dtensor(v, mesh))


def _own_kv_heads(k, v, h_local: int, r: int, n_rep: int):
    """``(k, v, n_rep)`` for model rank ``r``'s ``h_local`` query heads
    ``r * h_local ..``, from k and v with every kv head: query head ``j``
    reads kv head ``j // n_rep``.  The heads it reads are sliced (a view)
    with the query heads a kv head serves as the new ``n_rep``; a split
    with unequal shares repeats them, one a query head."""
    idx = [(r * h_local + j) // n_rep for j in range(h_local)]
    lo, cnt = idx[0], idx[-1] - idx[0] + 1
    if h_local % cnt == 0 and idx == [lo + j // (h_local // cnt) for j in range(h_local)]:
        return k[:, :, lo:lo + cnt], v[:, :, lo:lo + cnt], h_local // cnt
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel), 1


def batch_layout(x):
    """An activation ``(B, ...)`` pinned to :func:`batch_placements`.
    Each sublayer starts from it, so no layout DTensor's propagation
    chose inside one (a sequence dim over "model", say) reaches the
    next.  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    want = batch_placements(x.device_mesh, x.shape[0])
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def gather_dim(x, dim: int):
    """A DTensor with dim ``dim`` whole on every rank (its other dims as
    they were); a plain tensor as it is."""
    if not is_dtensor(x):
        return x

    dim = dim % x.dim()
    want = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


class _Bound(nn.Module):
    """``fn(m, *args)`` as a module's forward, ``m`` its submodule, so that
    ``functional_call`` can swap ``m``'s parameters for local tensors."""
    def __init__(self, fn, m: nn.Module):
        super().__init__()
        self.fn, self.m = fn, m

    def forward(self, *args):
        return self.fn(self.m, *args)


def batch_local(fn, module: nn.Module, x, state: dict | None = None):
    """``fn(module, x, state)`` -> ``(y, new_state)`` on each rank's rows
    of the batch alone.  On a DTensor ``x`` it runs in a ``local_map``:
    ``x`` and every tensor of ``state`` (B, ...) in
    :func:`batch_placements`, ``module``'s parameters gathered whole
    (their gradients come back as partial sums over the batch axes, which
    DTensor reduces onto the parameters' layout).  The recurrent
    sublayers (Mamba's chunk scan, the xLSTM loops) run this way: each row
    of the batch is independent there, and DTensor has no backward for
    the chunk scan's strided writes.  Returns ``y`` and ``new_state`` (a
    dict, or None) in the batch layout."""
    if not is_dtensor(x):
        return fn(module, x, state)

    mesh = x.device_mesh
    bpl, rep = batch_placements(mesh, x.shape[0]), replicate(mesh)
    named = dict(module.named_parameters())
    keys = sorted(state) if state else []
    bound = _Bound(fn, module)

    def local(xl, *rest):
        params = {"m." + n: t for n, t in zip(named, rest)}
        sl = dict(zip(keys, rest[len(named):])) if state is not None else None
        y, new = torch.func.functional_call(bound, params, (xl, sl))
        return (y, *[new[k] for k in keys]) if keys else y

    out = local_map(
        local,
        out_placements=tuple(list(bpl) for _ in range(1 + len(keys))) if keys else list(bpl),
        in_placements=(bpl, *[rep] * len(named), *[bpl] * len(keys)),
        in_grad_placements=(bpl, *[_summed_over_batch(bpl)] * len(named), *[bpl] * len(keys)),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, *named.values(), *[_dtensor(state[k], mesh) for k in keys])
    if not keys:
        return out, None
    return out[0], dict(zip(keys, out[1:]))


def on_batch_rows(fn, *args):
    """``fn(*args)`` for tensors of one batch ``(B, ...)``; on DTensors in
    a ``local_map`` over each rank's rows (every argument and the output
    in :func:`batch_placements`), so that a row-wise function — the
    loss's log-softmax over the vocabulary, say — and its backward pass
    never hold more than the rank's rows."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    bpl = batch_placements(mesh, args[0].shape[0])
    return local_map(fn, out_placements=list(bpl), in_placements=(bpl,) * len(args),
                     device_mesh=mesh, redistribute_inputs=True)(
        *[_dtensor(a, mesh) for a in args])


def gather_rows(table, idx):
    """``table[idx]``: an embedding lookup.  On a DTensor ``table`` it runs
    in a ``local_map``: the table gathered whole, each rank's rows of the
    batch of ``idx`` looked up locally, the output in the batch layout,
    and the table's gradient a partial sum over the batch axes.  (DTensor's
    own strategies for a vocab-sharded lookup mask rows that are not the
    rank's, and mis-shape that mask on a batch-sharded index.)"""
    if not is_dtensor(table):
        return table[idx]

    mesh = table.device_mesh
    bpl = batch_placements(mesh, idx.shape[0])
    return local_map(lambda t, i: t[i], out_placements=list(bpl),
                     in_placements=(replicate(mesh), bpl),
                     in_grad_placements=(_summed_over_batch(bpl), bpl),
                     device_mesh=mesh, redistribute_inputs=True)(table, _dtensor(idx, mesh))


def sharded_context():
    """The context the model's code runs in on DTensors: plain tensors it
    creates (masks, positions, zeros) count as replicated."""
    return implicit_replication()


def maybe_sharded(mesh):
    """:func:`sharded_context` with a mesh, else nothing."""
    return sharded_context() if mesh is not None else contextlib.nullcontext()


def distribute(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``t`` (the same whole tensor on every rank) as a DTensor laid out by
    ``spec``: each rank keeps its own shard, nothing is sent."""
    d = distribute_tensor(t, mesh, rules.to_placements(mesh, spec), src_data_rank=None)
    loc = d.to_local()
    if loc.untyped_storage().nbytes() != loc.numel() * loc.element_size():
        # a view of the whole tensor, or of an expanded row: the shard alone
        d = DTensor.from_local(loc.clone(), mesh, d.placements, run_check=False)
    return d


def distribute_params(params: nn.Module, mesh) -> nn.Module:
    """Every parameter of ``params`` replaced, in place, by a DTensor laid
    out by ``rules.param_specs`` over ``mesh`` (``requires_grad`` kept)."""
    specs = rules.param_specs(mesh, params)
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        p = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), mesh, spec), requires_grad=p.requires_grad)
    return params


def shard_batch(batch: dict, mesh) -> dict:
    """A batch's tensors as DTensors laid out by ``rules.data_spec``."""
    specs = rules.data_spec(mesh, batch)
    return {k: distribute(v, mesh, specs[k]) for k, v in batch.items()}


def shard_cache(cache, mesh, *, seq_sharded: bool):
    """Every tensor of a decode ``Cache`` replaced, in place, by a DTensor
    laid out by ``rules.cache_spec``."""
    specs = rules.cache_spec(mesh, cache, seq_sharded=seq_sharded)
    for layer, lspec in zip(cache.layers, specs):
        for slot, d in layer.items():
            for k in d:
                d[k] = distribute(d[k], mesh, lspec[slot][k])
    return cache


def replicated(x):
    """A DTensor redistributed to ``Replicate`` on every mesh dim (a
    ``Partial`` sum reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, replicate(x.device_mesh))


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (..., n * hd) viewed as (..., n, hd).  A DTensor whose last
    dim is sharded over more ranks than ``n`` splits into is gathered on
    that dim first (DTensor cannot unflatten it otherwise)."""
    if is_dtensor(x):
        last, mesh = x.dim() - 1, x.device_mesh
        ways = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if p.is_shard(last))
        if n % ways:
            x = x.redistribute(mesh, [Replicate() if p.is_shard(last) else p
                                      for p in x.placements])
    return x.unflatten(-1, (n, x.shape[-1] // n))


def full(x):
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x
