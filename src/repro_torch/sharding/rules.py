"""Named-axis sharding rules (port of ``src/repro/sharding/rules.py``):
parameters are FSDP-sharded (the wide axis over "model" for tensor
parallelism, the d_model axis over the batch axes for ZeRO-3-style weight
sharding); activations shard the batch over every non-"model" axis.

A spec is a tuple with one entry per dim, the port's ``PartitionSpec``:
``None``, an axis name, or a tuple of names.  The rules take any mesh
with ``.shape`` (axis name → size) and ``.axis_names``, so they run
without a process group; :func:`to_placements` turns a spec into DTensor
placements over a ``DeviceMesh``.  Dims that do not divide their axes
fall back to replication (elastic meshes).

Rules are resolved by parameter *leaf name*, the last component of a
``named_parameters`` name.  The reference stacks each layer group on a
leading ``n_repeat`` axis and tests ranks on the stacked shape; the port
unrolls layers (``models/convert.py``), so a leaf under ``layers.`` or
``enc_layers.`` is judged on its rank plus one, and its spec is the
reference's without the stack dim.  Caches likewise: the reference's
``(n_repeat, B, ...)`` is the port's ``(B, ...)``.  The reference's
``ndim == 5`` decode test catches the mLSTM state ``(B, H, hd, hd)`` as
well as attention's ``(B, S, K, hd)``, and its "sequence" dim is dim 1
of whatever the cache holds; the port keeps both decisions.
"""

from __future__ import annotations

import math
import os
from typing import Any

import torch

_BATCH = "B"  # constrain's stand-in for every non-"model" axis


def opt_sharding_enabled() -> bool:
    """Beyond-baseline activation sharding: explicit head/seq/expert
    constraints and the gather-friendly embedding layout; read from
    ``REPRO_OPT_SHARDING`` at every call."""
    return os.environ.get("REPRO_OPT_SHARDING", "0") == "1"


_ACTIVE_MESH: list = []


def set_active_mesh(mesh) -> None:
    """The mesh that :func:`constrain`, the attention cache write and the
    MoE dispatch shard over (``None`` clears it).  Launchers set it next
    to building the mesh."""
    _ACTIVE_MESH.clear()
    if mesh is not None:
        _ACTIVE_MESH.append(mesh)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _size(mesh, names) -> int:
    return math.prod(mesh.shape[a] for a in names)


def _entry(names: tuple):
    return names if len(names) > 1 else names[0]


class _Mesh:
    """The axis names and sizes of ``mesh``: an abstract mesh with
    ``.axis_names`` and a ``.shape`` dict, or a ``DeviceMesh``."""

    def __init__(self, mesh):
        names = tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)
        shape = mesh.shape
        self.axis_names = names
        self.shape = dict(shape) if isinstance(shape, dict) else dict(zip(names, shape))


def _axes(mesh) -> _Mesh:
    return mesh if isinstance(mesh, _Mesh) else _Mesh(mesh)


def _fix(mesh, dim: int, s) -> Any:
    """One entry of :func:`constrain`'s spec: axes not on the mesh are
    dropped, and axes that do not divide ``dim`` replicate."""
    if s == _BATCH:
        s = batch_axes(mesh)
    if s is None:
        return None
    ax = tuple(a for a in (s if isinstance(s, (tuple, list)) else (s,))
               if a in mesh.shape)
    return _entry(ax) if ax and dim % _size(mesh, ax) == 0 else None


def constrain(x, *spec):
    """Pin a DTensor activation's layout (the reference's
    ``with_sharding_constraint``): ``x.redistribute`` to ``spec`` over the
    active mesh.  Entries are axis names, ``None``, tuples of names, or
    ``"B"`` for every batch axis.  The identity on a plain tensor or with
    no active mesh."""
    from torch.distributed.tensor import DTensor

    if not _ACTIVE_MESH or not isinstance(x, DTensor):
        return x
    mesh = _axes(x.device_mesh)
    fixed = tuple(_fix(mesh, dim, s) for dim, s in zip(x.shape, spec))
    fixed += (None,) * (x.dim() - len(fixed))
    return x.redistribute(x.device_mesh, to_placements(x.device_mesh, fixed))


# leaf name -> spec template over the *trailing* dims (leading dims are
# padded with None).  "D" = shard over the batch axes, "M" = over model.
_RULES: dict[str, tuple] = {
    "embed": ("M", "D"),
    "lm_head": ("D", "M"),
    "wq": ("D", "M"),
    "wk": ("D", "M"),
    "wv": ("D", "M"),
    "wo": ("M", "D"),
    "w_gate": ("D", "M"),
    "w_up": ("D", "M"),
    "w_down": ("M", "D"),
    "router": ("D", None),
    "in_proj": ("D", "M"),
    "out_proj": ("M", "D"),
    "x_proj": ("M", None),
    "dt_proj": (None, "M"),
    "A_log": ("M", None),
    "conv_w": (None, "M"),
    "up": ("D", "M"),
    "down": ("M", "D"),
    "proj1": ("D", "M"),
    "proj2": ("M", "D"),
    # per-gate xlstm projections
    "wi": ("D", "M"),
    "wf": ("D", "M"),
    "wz": ("D", "M"),
    "wo_g": ("D", "M"),
}
# expert tensors: (E, in, out)
_RULES_3D = {
    "w_gate": (None, "D", "M"),
    "w_up": (None, "D", "M"),
    "w_down": (None, "M", "D"),
}
_STACKED = ("layers.", "enc_layers.")


def _axis_ok(mesh, names, dim: int) -> bool:
    if not names or any(a not in mesh.shape for a in names):
        return False  # elastic meshes may lack an axis entirely
    return dim % _size(mesh, names) == 0


def _resolve(mesh, template, shape, stacked: bool) -> tuple:
    """``template`` over the trailing dims of ``shape`` — of the
    reference's stacked shape when ``stacked``, whose leading stack dim
    (any size: its entry is dropped) the template may cover."""
    full = ((0,) if stacked else ()) + tuple(shape)
    d_ax = batch_axes(mesh)
    out: list = [None] * (len(full) - len(template))
    for t, dim in zip(template, full[len(out):]):
        if t == "D" and _axis_ok(mesh, d_ax, dim):
            out.append(_entry(d_ax))
        elif t == "M" and _axis_ok(mesh, ("model",), dim):
            out.append("model")
        else:
            out.append(None)
    return tuple(out[1:] if stacked else out)


def _leaves(tree) -> dict:
    """name -> shaped leaf: a module's parameters or a flat dict."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def param_spec(mesh, name: str, shape) -> tuple:
    """The spec of the parameter ``name`` (a ``named_parameters`` name)
    of ``shape``."""
    mesh = _axes(mesh)
    leaf = name.rsplit(".", 1)[-1]
    stacked = name.startswith(_STACKED)
    shape = tuple(shape)
    rank = len(shape) + stacked  # the reference's rank
    if leaf == "embed" and opt_sharding_enabled():
        # gather-friendly layout: vocab replicated, d_model over data —
        # token lookups become local row gathers
        return _resolve(mesh, (None, "D"), shape, stacked)
    if leaf in ("wi", "wf") and rank >= 2 and shape[-1] <= 128:
        return (None,) * len(shape)  # tiny gate heads: replicate
    if leaf in ("w_gate", "w_up", "w_down") and rank >= 3:
        n_model = mesh.shape.get("model", 1)
        # expert parallelism applies to expert tensors only: the
        # reference's 4-D (L, E, D, F), the port's 3-D (E, D, F)
        if opt_sharding_enabled() and rank >= 4 and shape[-3] % n_model == 0:
            tpl = ("M", "D", None) if leaf != "w_down" else ("M", None, "D")
            return _resolve(mesh, tpl, shape, stacked)
        return _resolve(mesh, _RULES_3D[leaf], shape, stacked)
    if leaf in _RULES and rank >= 2:
        return _resolve(mesh, _RULES[leaf], shape, stacked)
    if rank >= 2 and shape[-1] >= 1024:
        # fallback for unnamed wide matrices
        return _resolve(mesh, ("D", "M"), shape, stacked)
    return (None,) * len(shape)  # norms, biases, scalars


def param_specs(mesh, params_spec) -> dict:
    """name -> spec for every parameter of ``params_spec`` (a module, or a
    dict of name -> tensor such as ``Model.params_spec()``)."""
    return {n: param_spec(mesh, n, p.shape) for n, p in _leaves(params_spec).items()}


def data_spec(mesh, batch_spec: dict) -> dict:
    """Batch inputs: dim 0 over every non-model axis where it divides."""
    mesh = _axes(mesh)
    d_ax = batch_axes(mesh)
    n_data = _size(mesh, d_ax)

    def visit(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        if leaf.shape[0] % n_data:
            return (None,) * nd
        return (_entry(d_ax),) + (None,) * (nd - 1)

    return {k: visit(v) for k, v in batch_spec.items()}


def cache_leaf_spec(mesh, shape, *, seq_sharded: bool) -> tuple:
    """The spec of one cache leaf of ``shape`` ``(B, ...)``."""
    mesh = _axes(mesh)
    d_ax = batch_axes(mesh)
    ax = _entry(d_ax)
    n_data = _size(mesh, d_ax)
    n_model = mesh.shape.get("model", 1)
    nd = len(shape)
    if nd == 0:
        return ()
    rank = nd + 1  # the reference's stacked (n_repeat, B, ...)
    if rank >= 3:
        if shape[0] % n_data == 0 and not seq_sharded:
            spec = [None] * nd
            spec[0] = ax
            if (opt_sharding_enabled() and rank == 5
                    and shape[1] % n_model == 0 and shape[1] > n_model):
                # decode: the KV seq axis over "model" too — each rank
                # reads 1/n_model of the cache
                spec[1] = "model"
            return tuple(spec)
        if seq_sharded and rank >= 4 and shape[1] % n_data == 0:
            spec = [None] * nd
            spec[1] = ax  # the sequence axis of (B, S, K, hd)
            if opt_sharding_enabled() and shape[1] % (n_data * n_model) == 0:
                spec[1] = (*d_ax, "model")
            return tuple(spec)
    return (None,) * nd


def cache_spec(mesh, cache_spec_tree, *, seq_sharded: bool):
    """KV and state caches: the batch dim where the batch divides the
    batch axes, else (long context, batch 1, ``seq_sharded``) the
    sequence axis of attention caches.  ``cache_spec_tree`` is a
    ``Cache`` (or its ``layers`` list); the result has the same nesting
    of lists and dicts, a spec in place of each tensor."""
    tree = getattr(cache_spec_tree, "layers", cache_spec_tree)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v) for v in node]
        return cache_leaf_spec(mesh, tuple(node.shape), seq_sharded=seq_sharded)

    return visit(tree)


def decode_seq_axes(batch: int, seq: int) -> tuple[str, ...]:
    """The mesh axes the decode KV cache's seq dim is sharded over (must
    mirror :func:`cache_spec`'s opt-mode decisions)."""
    if not (_ACTIVE_MESH and opt_sharding_enabled()):
        return ()
    mesh = _axes(_ACTIVE_MESH[0])
    d_ax = batch_axes(mesh)
    n_data = _size(mesh, d_ax)
    n_model = mesh.shape.get("model", 1)
    if batch % n_data == 0:
        return ("model",) if (seq % n_model == 0 and seq > n_model) else ()
    if seq % (n_data * n_model) == 0:
        return (*d_ax, "model")
    return ()


def to_placements(mesh, spec) -> list:
    """DTensor placements over the ``DeviceMesh`` ``mesh`` for ``spec``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, else
    ``Replicate()``.  A dim sharded over several axes is split in mesh
    order, as a ``NamedSharding`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axes(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, s in enumerate(spec):
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            out[names.index(a)] = Shard(d)
    return out
