"""Device ms a call in the work that ordering by the whole key adds to
``sort_device``: the kernels, copies and fills launched inside the
program's ``repro_torch.full_key`` span (the tie runs' numbering, their
sort by tail), as ``spans.by_span`` attributes them.  None where the
program opens no such span or the run kept no span breakdown."""

SPAN = "repro_torch.full_key"


def read(ctx):
    s = getattr(ctx, "span_device_s", {}).get(SPAN)
    if not s or not ctx.calls:
        return None
    return s * 1e3 / len(ctx.calls)
