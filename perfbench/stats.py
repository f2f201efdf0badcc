"""Percentiles over every call of a window (never over chunk medians)."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile of every value: the smallest
    value with at least ``q`` % of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(1, math.ceil(q / 100 * len(s))) - 1]
