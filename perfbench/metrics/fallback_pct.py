"""Share of the window's calls whose ``sort_device`` returned
``overflow`` true: a bucket over its row, so the stable fallback sorted
the array and the grid was thrown away."""


def read(ctx):
    return 100.0 * sum(c.overflow for c in ctx.calls) / len(ctx.calls)
