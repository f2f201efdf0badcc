"""A loop over a sequence, the port's ``lax.scan``.

``scan(step, carry, xs)`` runs ``carry, y_t = step(carry, x_t)`` for each
position ``t`` of ``xs`` along ``dim`` and stacks the ``y_t``.  On real
tensors it is the plain Python loop.  Under the dry run's
``launch.cost_analysis.CostMode`` it runs one step and counts it for all
of them (``CostMode.scan_step``: the first step, then one counted for
the rest), as the reference's HLO analysis
multiplies a ``lax.scan`` body by its trip count: the outputs have their
full shapes, and on ``meta`` tensors nothing is computed.  The mode
announces itself in :data:`counter` while it is active, so that this
module needs nothing of the launcher and the plain loop costs one read.
"""

from __future__ import annotations

import torch

# the dry run's CostMode while one is active (it sets and clears this);
# None: the plain loop
counter = None


def _take(xs: torch.Tensor, dim: int, t: int, keepdim: bool) -> torch.Tensor:
    return xs.narrow(dim, t, 1) if keepdim else xs.select(dim, t)


def scan(step, carry, xs: torch.Tensor, *, dim: int = 1, keepdim: bool = False):
    """``(carry, ys)``: ``step(carry, x_t) -> (carry, y_t)`` over
    ``xs.select(dim, t)`` (``keepdim``: ``xs.narrow(dim, t, 1)``), the
    ``y_t`` stacked (``keepdim``: concatenated) along ``dim``."""
    n = xs.shape[dim]
    mode = counter
    if mode is not None and n > 2:
        # the first step as it is (its initial state needs no gradient),
        # then one step counted for the other n - 1, its slice taken
        # inside it so that the slice's backward counts n - 1 times too
        carry, y0 = step(carry, _take(xs, dim, 0, keepdim))
        carry, y = mode.scan_step(n - 1, lambda c: step(c, _take(xs, dim, 1, keepdim)), carry)
        return carry, mode.stack_steps(y0, y, n, dim, keepdim)
    ys = []
    for t in range(n):
        carry, y = step(carry, _take(xs, dim, t, keepdim))
        ys.append(y)
    return carry, (torch.cat if keepdim else torch.stack)(ys, dim)
