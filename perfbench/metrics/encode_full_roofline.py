"""The full-key encode kernel's (``csrc/encode.cu``
``encode_full_kernel``) least time over its device time, in %: every
call encodes its records through it once."""

from perfbench import full_key_roofline, roofline


def read(ctx):
    bw = roofline.hbm_bytes_per_s(ctx.device_name)
    t = ctx.trace.kernel_seconds("encode_full_kernel") if ctx.trace else 0.0
    if bw is None or t <= 0:
        return None
    k = ctx.config["key_bytes"]
    least = sum(full_key_roofline.encode_full_bytes(c.n, k) for c in ctx.calls) / bw
    return 100.0 * least / t
