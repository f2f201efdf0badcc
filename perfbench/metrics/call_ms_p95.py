"""The 95th percentile (nearest rank) of every call's time in the window,
from the call's entry to its ``torch.cuda.synchronize()``, in ms."""

from perfbench import stats


def read(ctx):
    return stats.percentile([c.seconds for c in ctx.calls], 95) * 1e3
