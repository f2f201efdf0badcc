"""Bytes the Partition stage spilled to disk, as a share of the input's
bytes, in %: ``SortStats.spill_disk_bytes / input_bytes`` (the
program's counters; fragments past the RAM spill budget of half the
memory budget), the mean over the window's calls."""

from perfbench import file_stats


def read(ctx):
    share = file_stats.mean(ctx, lambda s: s.spill_disk_bytes / s.input_bytes
                            if s.input_bytes else None)
    return None if share is None else 100.0 * share
