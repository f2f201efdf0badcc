"""The row sorter's launch geometry and stage layout, on the CPU.

``csrc/bitonic.cu`` runs only on a card (``tests/test_torch_cuda.py``
holds it against its plain version there).  What surrounds it is Python
that runs here: :func:`bitonic.launch_geometry` chooses the launch for
every width, and :func:`bitonic.stage_split` counts where the network's
stages run.  ``_emulate`` replays the kernel's schedule (registers,
shuffle partners, shared-memory partners and their directions) in NumPy
on that geometry, so a fault in the layout shows here first.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import bitonic  # noqa: E402

WIDTHS = [1 << i for i in range(bitonic.MAX_WIDTH.bit_length())]
SHARED_LIMIT = 232_448  # bytes of shared memory an H100 block may opt into


@pytest.mark.parametrize("c", WIDTHS)
def test_launch_geometry_covers_each_row(c):
    g = bitonic.launch_geometry(c)
    threads = g.rows_per_block * g.threads_per_row
    assert threads <= 1024
    assert threads % 32 == 0
    assert g.shared_bytes <= SHARED_LIMIT
    # the block's threads hold its rows' slots, each slot once, and its
    # shared memory holds them too (12 bytes a slot)
    slots = g.rows_per_block * c
    assert g.rows_per_block * g.threads_per_row * g.elems == slots
    assert g.shared_bytes >= 12 * slots
    assert g.threads_per_row <= 32 or g.rows_per_block == 1


@pytest.mark.parametrize("c", [0, 3, 100, 2 * bitonic.MAX_WIDTH])
def test_launch_geometry_rejects_widths(c):
    with pytest.raises(ValueError):
        bitonic.launch_geometry(c)


def test_stage_split_at_the_main_path_width():
    """At C = 1024 one warp holds a row: 40 stages in registers, 15 by
    shuffles, none through shared memory, and 2 shared round trips (the
    layout passes in and out) against the 55 of a shared-memory network."""
    assert bitonic.stage_split(1024) == {
        "registers": 40, "shuffles": 15, "shared": 0, "shared_round_trips": 2,
    }
    for c in WIDTHS:
        s = bitonic.stage_split(c)
        n = c.bit_length() - 1
        assert s["registers"] + s["shuffles"] + s["shared"] == n * (n + 1) // 2


def _key(a):
    return (a[..., 0].astype(np.uint64) << np.uint64(32)) | a[..., 1].astype(
        np.uint64
    )


def _greater(a, b):
    ka, kb = _key(a), _key(b)
    return (ka > kb) | ((ka == kb) & (a[..., 2] > b[..., 2]))


def _emulate(row, e):
    """One row through the kernel's schedule: thread t holds slots
    t*e .. t*e + e - 1 as ``x[t]``; a stage's partner is a register, a
    lane ``t ^ (j / e)`` or (j >= 32 e) another warp's thread."""
    c = row.shape[0]
    t_n = c // e
    x = row.reshape(t_n, e, 3).copy()
    first = np.arange(t_n) * e

    def registers(j, asc_of):
        for s in range(e):
            if s & j == 0:
                a, b = x[:, s].copy(), x[:, s | j].copy()
                sw = (_greater(a, b) == asc_of(s))[:, None]
                x[:, s], x[:, s | j] = np.where(sw, b, a), np.where(sw, a, b)

    def partner(j, keep_min):
        p = x[np.arange(t_n) ^ (j // e)]
        take = np.where(keep_min[:, None], _greater(x, p), _greater(p, x))
        x[:] = np.where(take[..., None], p, x)

    k = 2
    while k <= e:  # levels inside a thread
        j = k // 2
        while j:
            registers(j, lambda s, k=k: ((first & k) | (s & k)) == 0)
            j //= 2
        k *= 2
    while k <= c:
        asc = (first & k) == 0
        j = k // 2
        while j >= e:  # another warp (j >= 32 e) or another lane
            partner(j, ((first & j) == 0) == asc)
            j //= 2
        j = e // 2
        while j:
            registers(j, lambda s: asc)
            j //= 2
        k *= 2
    return x.reshape(c, 3)


@pytest.mark.parametrize("c", WIDTHS)
def test_schedule_sorts_strictly(c):
    """The kernel's schedule on its geometry sorts by (hi, lo, val),
    SENTINEL keys last, full duplicates kept, at every width."""
    e = bitonic.launch_geometry(c).elems
    rng = np.random.default_rng(c)
    for dup in (2**32, 3):
        row = np.stack([
            rng.integers(0, dup, c), rng.integers(0, 3, c),
            rng.integers(-(2**31), 2**31 - 1, c) if dup > 3
            else rng.integers(0, 4, c),
        ], 1).astype(np.int64)
        row[rng.random(c) < 0.2, :2] = 0xFFFFFFFF
        want = row[np.lexsort((row[:, 2], row[:, 1], row[:, 0]))]
        np.testing.assert_array_equal(_emulate(row, e), want)
