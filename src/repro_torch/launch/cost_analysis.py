"""Cost analysis of one traced call: the port's counterpart of
``src/repro/launch/hlo_analysis.py``.

The reference reads the three roofline inputs per device off compiled
HLO text, multiplying each op by the trip counts of the loops around it.
Eager PyTorch has no HLO: :func:`analyze` runs the call once under a
``TorchDispatchMode`` (on fake tensors, so nothing is allocated) and
counts every aten op as it is dispatched:

  * dot_flops   — 2 x M x N x K over ``mm``, ``addmm``, ``bmm``,
                  ``baddbmm`` (``matmul`` and ``einsum`` reach these)
                  and the fused attention ops; elementwise work is left
                  out, as the reference leaves it out;
  * hbm_bytes   — operand + result bytes of every op that is not a view.
                  Eager torch does not fuse, so this is an upper bound
                  beside the reference's post-fusion count;
  * collectives — count, result bytes and largest group size by kind
                  (the reference's names: all-gather, all-reduce,
                  reduce-scatter, all-to-all);
  * peak_bytes  — the most bytes held at once by tensors the call made
                  (each op's new outputs, alive until they are freed):
                  the temp memory beside the call's arguments.

Python loops (layers, microbatches, attention blocks) run unrolled, so
their counts are exact by construction.  A recurrence over a sequence
(``models/recurrence.scan``: the sLSTM loop over time, the token by
token prefill) is the exception, as the reference's ``lax.scan`` is:
under the mode its first step runs as it is (its initial state needs
no gradient), then one step runs and counts, with its backward and its
remat recompute, for the other n - 1 (:meth:`CostMode.scan_step`), as
the reference's ``_multipliers`` do.  At 4,096 or 32,768 steps a layer
the unrolled trace takes hours; at 16 steps the two agree exactly in
FLOPs and collectives (``tests/test_torch_recurrence.py``).  On
DTensors the mode steps aside for DTensor's own dispatch and counts the
ops DTensor runs on the local shards and the collectives it issues: the
counts are per device, as the reference's are after SPMD partitioning
(a mode above DTensor, such as ``FlopCounterMode``, would count each op
at its global shape).  DTensor's own shape propagation,
which runs each new op once at its global shape on fake tensors, is not
counted.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import recurrence

_COLL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_FREE = {"device", "dtype", "layout", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "lift_fresh", "detach", "alias", "_local_scalar_dense", "wait_tensor",
         "_to_copy_meta", "sym_size", "sym_stride", "sym_numel"}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name in ("_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
                "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_for_cpu"):
        q, k, v = args[:3]  # (B, H, Sq, hd), (B, H, Sk, hd)
        return 2.0 * math.prod(q.shape[:-1]) * k.shape[-2] * (q.shape[-1] + v.shape[-1])
    return 0.0


def _group_size(args, kwargs) -> int:
    for a in (*args, *kwargs.values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return _resolve_process_group(a).size()
            except Exception:  # a reduce op's name, not a group's
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) and callable(a.size):
            return a.size()
    return 1


@dataclasses.dataclass
class Cost:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: {"count": 0.0, "result_bytes": 0.0, "max_group": 1}
        )
    )
    by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0.0, 0.0]))
    peak_bytes: int = 0

    def as_dict(self) -> dict:
        """The keys of the reference's ``HloCost.as_dict()``."""
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
        }

    def breakdown(self, top: int = 20) -> list[tuple[str, str, float, float]]:
        """Per-op attribution ``[(op, overload, bytes, dot_flops)]`` sorted
        by bytes (the reference's ``breakdown``, by aten op)."""
        rows = [(op, ov, b, f) for (op, ov), (b, f) in self.by_op.items()]
        rows.sort(key=lambda r: -r[2])
        return rows[:top]


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched beneath it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._hidden = 0
        self._live = 0
        self.mult = 1  # each op counts this many times (a scaled step's)
        self._made = None  # weakrefs of the tensors a scaled step makes

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        meta = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self

        def propagate(prop, op_schema):
            mode._hidden += 1
            try:
                return meta(prop, op_schema)
            finally:
                mode._hidden -= 1

        self._restore = (ShardingPropagator, meta, recurrence.counter)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        recurrence.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        cls, meta, outer = self._restore
        cls._propagate_tensor_meta_non_cached = meta
        recurrence.counter = outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not _is_fake(t) for t in types):
            return NotImplemented  # a DTensor: count what it runs locally
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def _hold(self, func, args, kwargs, out) -> None:
        """Count ``out``'s new tensors as live until they are freed."""
        if func.is_view:
            return
        ins = {id(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if id(t) in ins:  # an in-place op returns its argument
                continue
            nb = _nbytes(t)
            self._live += nb
            weakref.finalize(t, self._free, nb)
            if self._made is not None:
                self._made.append(weakref.ref(t))
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _extra_live(self, nbytes: int) -> None:
        self._live += nbytes
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _count(self, func, args, kwargs, out) -> None:
        self._hold(func, args, kwargs, out)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        c, m = self.cost, self.mult
        if ns in ("_c10d_functional", "c10d") and name in _COLL:
            rec = c.collectives[_COLL[name]]
            rec["count"] += m
            rec["result_bytes"] += m * sum(_nbytes(t) for t in _tensors(out))
            rec["max_group"] = max(rec["max_group"], _group_size(args, kwargs))
            return
        if name in _FREE or func.is_view:
            return
        tensors = _tensors((args, kwargs, out))
        self._add(name, func._overloadname, m * sum(_nbytes(t) for t in tensors),
                  m * _dot_flops(name, args, out))

    def _add(self, name: str, overload: str, nbytes: float, flops: float) -> None:
        c = self.cost
        c.dot_flops += flops
        c.hbm_bytes += nbytes
        rec = c.by_op[(name, overload)]
        rec[0] += nbytes
        rec[1] += flops

    # -- one step of a recurrence, counted for ``n`` ------------------------

    def scan_step(self, n: int, fn, carry):
        """``fn(carry)`` — one step of a recurrence, ``(carry, y)`` — run
        once and counted as ``n`` runs of it, the reference's trip-count
        multiplier over a ``lax.scan`` body:

        * its ops (FLOPs, bytes, collectives) count ``n`` times, and so
          does a remat recompute of it, which runs this again;
        * under autograd, the backward of every graph node it made counts
          ``n`` times (node pre- and post-hooks scale ``mult`` around the
          node), plus the ``n - 1`` gradient additions that ``n`` steps
          would make into each tensor from outside the step other than
          the carry (whose gradient goes to the step before);
        * each tensor it made that outlives it (the residuals autograd
          keeps for the backward) holds ``n - 1`` more copies of its
          bytes in ``peak_bytes`` for as long as it lives.

        The step's temporaries live once, as they would in a loop."""
        skip = {t.grad_fn for t in _tensors(carry) if t.grad_fn is not None}
        seq0 = _sequence_nr()
        made, self._made = self._made, []
        self.mult *= n
        try:
            out = fn(carry)
        finally:
            self.mult //= n
            made, self._made = self._made, made
        if self._made is not None:
            self._made.extend(made)
        outs = _tensors(out)
        keep = {id(t) for t in outs} | {id(t._base) for t in outs if t._base is not None}
        for ref in made:
            t = ref()
            if t is not None and id(t) not in keep:  # a residual
                extra = (n - 1) * _nbytes(t)
                self._extra_live(extra)
                weakref.finalize(t, self._free, extra)
        if torch.is_grad_enabled():
            self._scale_backward(outs, seq0, _sequence_nr(), n, skip)
        return out

    def _scale_backward(self, outs, seq0: int, seq1: int, n: int, skip) -> None:
        """Hooks on the autograd nodes made between sequence numbers
        ``seq0`` and ``seq1`` that ``outs`` reach: each counts ``n``
        times when the backward pass runs it.  Gradients into ``skip``
        (the carry's nodes) are not summed over steps."""
        todo = [t.grad_fn for t in outs if t.grad_fn is not None]
        seen, inside = set(), []
        while todo:
            node = todo.pop()
            if node in seen:
                continue
            seen.add(node)
            if seq0 <= node._sequence_nr() < seq1:
                inside.append(node)
                todo.extend(f for f, _ in node.next_functions if f is not None)
        members = set(inside)

        def pre(grad_outputs):
            self.mult *= n

        def post_for(edges):
            def post(grad_inputs, grad_outputs):
                self.mult //= n
                # n steps would add n gradients into each outside input
                for i in edges:
                    g = grad_inputs[i]
                    if g is not None:
                        self._add("add", "Tensor", self.mult * (n - 1) * 3 * _nbytes(g), 0.0)
            return post

        for node in inside:
            edges = [i for i, (f, _) in enumerate(node.next_functions)
                     if f is not None and f not in members and f not in skip]
            node.register_prehook(pre)
            node.register_hook(post_for(edges))

    def stack_steps(self, y0: torch.Tensor, y: torch.Tensor, n: int, dim: int,
                    keepdim: bool) -> torch.Tensor:
        """The first step's output ``y0`` and a scaled step's ``y`` (for
        the other ``n - 1``) as the stack (``keepdim``: the
        concatenation) of ``n`` outputs along ``dim``: the copy counted
        as the loop's stack, the other ``n - 2`` outputs held for it; its
        backward hands each its slice, a view, as the stack's does."""
        extra = (n - 2) * _nbytes(y)
        self._extra_live(extra)
        try:
            return _Steps.apply(y0, y, n, dim, keepdim)
        finally:
            self._free(extra)


def _sequence_nr() -> int:
    """The sequence number autograd gives the next node it makes."""
    return torch._C._autograd._get_sequence_nr()


class _Steps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y0, y, n, dim, keepdim):
        ctx.dim, ctx.keepdim = dim, keepdim
        return (torch.cat if keepdim else torch.stack)([y0] + [y] * (n - 1), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.keepdim:
            return g.narrow(ctx.dim, 0, 1), g.narrow(ctx.dim, 1, 1), None, None, None
        return g.select(ctx.dim, 0), g.select(ctx.dim, 1), None, None, None


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, type) and issubclass(t, FakeTensor)


def analyze(fn, *args, fake: bool = True, **kwargs) -> Cost:
    """The cost of ``fn(*args, **kwargs)``, run once.  With ``fake`` the
    call runs under a ``FakeTensorMode`` (real tensor arguments become
    fake ones): shapes and dtypes only, nothing computed or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = CostMode()
    if fake:
        with FakeTensorMode(allow_non_fake_inputs=True), mode:
            fn(*args, **kwargs)
    else:
        with mode:
            fn(*args, **kwargs)
    return mode.cost
