"""Busy seconds of the Sort stage a call, summed over its sorter
threads: the batched executor packs the loaded partitions into
super-batches and sorts each on the card (encode, RMI, grid and row
sort, or the stable fallback), then the memcmp touch-up past byte 8
(``SortStats.phase_seconds["sort"]``; waits on the loader are not in
it), the mean over the window's calls."""

from perfbench import file_stats


def read(ctx):
    return file_stats.stage_busy_s(ctx, "sort")
