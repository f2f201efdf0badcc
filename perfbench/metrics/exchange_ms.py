"""Device ms a call in NCCL kernels (``ncclDevKernel_*``, ``ncclKernel_*``),
the mean over ranks: the distributed sort's two all-to-alls, the
pre-shuffle and the route, with any wait inside them for a slower rank
(the harness's own barriers are on a gloo group, off the card)."""

from perfbench.mesh_harness import nccl_seconds


def read(ctx):
    ranks = getattr(ctx, "ranks", [])
    if not ranks or any(r.trace is None for r in ranks):
        return None
    s = [nccl_seconds(r.trace) for r in ranks]
    if not all(s):
        return None
    return sum(s) / len(s) * 1e3 / len(ctx.calls)
