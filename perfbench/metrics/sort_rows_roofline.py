"""The row sorter's (``csrc/bitonic.cu``) least time over its device
time, in %: the calls that did not overflow sort their records by it."""

from perfbench import roofline


def read(ctx):
    bw = roofline.hbm_bytes_per_s(ctx.device_name)
    t = ctx.trace.kernel_seconds("bitonic_kernel") if ctx.trace else 0.0
    if bw is None or t <= 0:
        return None
    least = sum(roofline.sort_rows_bytes(c.n) for c in ctx.calls if not c.overflow) / bw
    return 100.0 * least / t
