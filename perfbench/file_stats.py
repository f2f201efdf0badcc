"""What the file-sort driver's readers take from the ``SortStats`` that
each call of ``sort_file`` returns (``FileContext.stats``)."""

from __future__ import annotations


def mean(ctx, value):
    """The mean of ``value(stats)`` over the window's calls; None where no
    call returned ``SortStats`` (a control in the program's place) or
    ``value`` gives None for one."""
    vals = [value(s) for s in getattr(ctx, "stats", []) if s is not None]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)


def stage_busy_s(ctx, phase: str):
    """Busy seconds of the pipeline stage ``phase`` a call, summed over
    the stage's threads (``SortStats.phase_seconds``, the program's
    ``PhaseClock``): the stage's own work, without its waits on the
    stages before it."""
    return mean(ctx, lambda s: s.phase_seconds.get(phase))
