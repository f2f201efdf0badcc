"""The RMI kernel's (``csrc/rmi.cu``) least time over its device time,
in %: every call routes its records through it once."""

from perfbench import roofline


def read(ctx):
    bw = roofline.hbm_bytes_per_s(ctx.device_name)
    t = ctx.trace.kernel_seconds("rmi_kernel") if ctx.trace else 0.0
    if bw is None or t <= 0:
        return None
    least = sum(roofline.rmi_bytes(c.n, ctx.config["n_leaf"]) for c in ctx.calls) / bw
    return 100.0 * least / t
