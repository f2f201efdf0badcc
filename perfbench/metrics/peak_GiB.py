"""The sort's own peak, in GiB: ``torch.cuda.max_memory_allocated()``
over the window (reset at its start) less what was allocated at its
start (the harness's input pool and answer slots, and the model).  The
HBM a sort of the mix's sizes needs, which caps the array a card can
sort; the whole process's peak is ``memory_peak_bytes``."""


def read(ctx):
    if ctx.device_name == "cpu":
        return None
    return (ctx.peak_bytes - ctx.base_bytes) / 2**30
