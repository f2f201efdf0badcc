"""The exchange's least time over its NCCL device time, in %, the mean
over ranks: the least bytes a rank must send (``roofline.exchange_bytes``:
the key words and payload of the 3/4 of its records that belong to other
ranks, once) over the card's link peak (``roofline.link_bytes_per_s``,
NVLink or PCIe as ``nvidia-smi topo -m`` shows the cards joined)."""

from perfbench import roofline
from perfbench.mesh_harness import nccl_seconds


def read(ctx):
    ranks = getattr(ctx, "ranks", [])
    bw = roofline.link_bytes_per_s(ctx.device_name, getattr(ctx, "link", None))
    if bw is None or not ranks or any(r.trace is None for r in ranks):
        return None
    least = sum(roofline.exchange_bytes(c.n // ctx.world, ctx.world) for c in ctx.calls) / bw
    shares = []
    for r in ranks:
        t = nccl_seconds(r.trace)
        if t <= 0:
            return None
        shares.append(100.0 * least / t)
    return sum(shares) / len(shares)
