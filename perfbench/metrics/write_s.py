"""Busy seconds of the Write stage a call, summed over the writer
pool's threads: the positioned writes of the sorted partitions into the
output (``SortStats.phase_seconds["write"]``; the writers' waits on the
sorter are not in it), the mean over the window's calls."""

from perfbench import file_stats


def read(ctx):
    return file_stats.stage_busy_s(ctx, "write")
