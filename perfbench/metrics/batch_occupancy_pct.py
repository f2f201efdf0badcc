"""Share of the batched executor's super-batch slots that held a
record, in %: ``100 * SortStats.batch_occupancy`` (records over the
padded slots of every dispatch, the program's counters), the mean over
the window's calls.  The rest is padding sorted with the records.  None
where a call dispatched no super-batch (an executor that batches
nothing) or none returned ``SortStats``."""

from perfbench import file_stats


def read(ctx):
    occ = file_stats.mean(ctx, lambda s: s.batch_occupancy or None)
    return None if occ is None else 100.0 * occ
