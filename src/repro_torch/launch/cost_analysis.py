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
every count is exact by construction: there are no trip counts to
multiply.  On DTensors the mode steps aside for DTensor's own dispatch
and counts the ops DTensor runs on the local shards and the collectives
it issues: the counts are per device, as the reference's are after SPMD
partitioning (a mode above DTensor, such as ``FlopCounterMode``, would
count each op at its global shape).  DTensor's own shape propagation,
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

        self._restore = (ShardingPropagator, meta)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, meta = self._restore
        cls._propagate_tensor_meta_non_cached = meta
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
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _count(self, func, args, kwargs, out) -> None:
        self._hold(func, args, kwargs, out)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        c = self.cost
        if ns in ("_c10d_functional", "c10d") and name in _COLL:
            rec = c.collectives[_COLL[name]]
            rec["count"] += 1
            rec["result_bytes"] += sum(_nbytes(t) for t in _tensors(out))
            rec["max_group"] = max(rec["max_group"], _group_size(args, kwargs))
            return
        if name in _FREE or func.is_view:
            return
        tensors = _tensors((args, kwargs, out))
        flops = _dot_flops(name, args, out)
        nbytes = sum(_nbytes(t) for t in tensors)
        c.dot_flops += flops
        c.hbm_bytes += nbytes
        rec = c.by_op[(name, func._overloadname)]
        rec[0] += nbytes
        rec[1] += flops


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
