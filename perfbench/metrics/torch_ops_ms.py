"""Device ms a call in work that the port's own CUDA library did not
launch: PyTorch's kernels, copies and fills (the partition glue, the
grid gathers, the compaction and the fallback's sort)."""

from perfbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    s = ctx.trace.seconds(lambda name: trace.kernel_id(name) not in ctx.port_kernels)
    return s * 1e3 / len(ctx.calls)
