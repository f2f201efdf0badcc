"""Busy seconds of the Partition stage a call, summed over the reader
pool's threads: each reads its stripes of the input, routes each record
to its partition by the model (or the planner's splitters) and spills
it, to RAM up to half the memory budget and to disk beyond
(``SortStats.phase_seconds["partition"]``), the mean over the window's
calls."""

from perfbench import file_stats


def read(ctx):
    return file_stats.stage_busy_s(ctx, "partition")
