"""Share of the traced window in which no kernel, copy or fill ran on a
card (``torch.profiler``), the mean over the ranks' cards."""


def read(ctx):
    ranks = getattr(ctx, "ranks", [])
    if not ranks or any(r.trace is None or r.trace.busy_s <= 0 for r in ranks):
        return None
    return sum(100.0 * (1.0 - r.trace.busy_s / r.trace.window_s) for r in ranks) / len(ranks)
