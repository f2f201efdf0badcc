"""Pre-sort planner: sample diagnostics, the hybrid model-vs-splitter

Copy of ``src/repro/core/planner.py`` for the PyTorch port.
partitioner decision, and auto-tuned sort knobs (DESIGN.md §11).

ELSAR's merge-free guarantee only needs *monotone* partitions, but its
**performance** needs *equi-depth* ones — and the learned CDF model only
delivers equi-depth partitions on inputs it can actually fit.  Hostile
inputs (duplicate floods, tiny key universes, heavy-tailed Zipfian keys)
push the model toward its fallback paths; the principled escape hatch is
the learning-augmented SampleSort framing (PAPERS.md): when a cheap
sample diagnostic says the model will mispartition, fall back to
**sample-splitter** (quantile) partitioning computed from the very same
sample the model was trained on.

The planner runs once per sort, on the training sample, before any
record is routed:

1. :func:`diagnose` — cheap sample statistics:

   * ``sortedness`` / ``mean_run_length`` — input-order statistics of
     the (run-structured) sample; presorted and reverse-sorted inputs
     announce themselves here.  These are **order-sensitive** by design.
   * ``dup_ratio`` / ``cardinality`` — duplicate mass and distinct-key
     count; a tiny universe caps how many useful partitions exist.
   * ``cdf_err`` — the max gap between the trained model's CDF and the
     sample's empirical CDF.  ``cdf_err * n_partitions`` estimates the
     worst partition's size in multiples of the mean — the direct
     mispartitioning risk.  (At duplicate spikes this deliberately
     counts the irreducible step mass: no monotone model can split a
     duplicated key, so a spiky sample reads as high-risk and routes to
     the splitter, whose boundaries at least land *between* spikes.)

   ``dup_ratio``, ``cardinality`` and ``cdf_err`` are permutation-stable
   (they sort the sample internally); the order statistics are not —
   tests/test_planner.py pins both properties.

2. :func:`choose_partitioner` — ``model`` unless the universe is tiny
   (``cardinality <= tiny_universe``) or the estimated partition skew
   ``cdf_err * n_partitions`` exceeds ``max_partition_skew``.

3. :func:`tune_knobs` — replaces the hand-set defaults with measured
   choices: ``n_partitions`` from the memory budget (capped by the
   sample cardinality — partitions beyond the number of distinct keys
   are guaranteed empty), the spill ``flush_bytes`` from the budget's
   per-reader, per-partition share, and the executor's super-batch
   ``batch_segments`` from the partition count.  Explicit caller values
   always win (0 means "auto" everywhere).

Both partitioners expose the same ``bucket_np(keys) -> int32 ids``
surface, both are monotone in memcmp key order (the concatenation
invariant, paper Eq. 1), and both feed the identical downstream stages —
spills, loader, the batched device executor, manifest, serving.  The
decision and diagnostics are recorded in ``SortStats`` so benchmarks and
CI assert the *choice*, not just the output bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import encoding, rmi

# Tuning floors/ceilings (see DESIGN.md §11 for the rationale).
MIN_FLUSH_BYTES = 32 << 10
MAX_FLUSH_BYTES = 1 << 20
MAX_BATCH_SEGMENTS = 32  # mirrors executor.MAX_SEGMENTS
MAX_WRITERS = 8  # writer-pool ceiling: past this, pwrite queues collide
_PART_BYTES_FLOOR = 1 << 20  # partitions never sized below 1 MB


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Decision thresholds (defaults chosen so the historical corpora —
    uniform and gensort-skewed — keep the model path)."""

    # "auto" | "model" | "splitter": non-auto forces the decision.
    partitioner: str = "auto"
    # distinct sample keys at or below which the splitter always wins:
    # the model's float CDF adds nothing over exact quantile boundaries.
    tiny_universe: int = 256
    # estimated worst-partition size, in multiples of the mean partition
    # (cdf_err * n_partitions), beyond which the model is not trusted.
    max_partition_skew: float = 4.0


@dataclasses.dataclass(frozen=True)
class SampleDiagnostics:
    """Cheap sample statistics the decision + tuner consume."""

    n_sample: int = 0
    sortedness: float = 1.0  # fraction of non-decreasing adjacent pairs
    mean_run_length: float = 0.0  # mean ascending-run length
    dup_ratio: float = 0.0  # 1 - cardinality / n_sample
    cardinality: int = 0  # distinct keys in the sample
    cdf_err: float = 0.0  # max |model CDF - empirical CDF| on the sample

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TunedKnobs:
    """The auto-tuned (or caller-pinned) sort knobs."""

    n_partitions: int
    flush_bytes: int
    batch_segments: int
    n_writers: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """One sort's routing decision + knobs, recorded in ``SortStats``."""

    decision: str  # "model" | "splitter"
    reason: str
    diagnostics: SampleDiagnostics
    partitioner: "ModelPartitioner | SplitterPartitioner"
    knobs: TunedKnobs


# ---------------------------------------------------------------------------
# Partitioners: the shared bucket_np surface
# ---------------------------------------------------------------------------


def _keys_sview(keys: np.ndarray) -> np.ndarray:
    """|S{K}| byte-string view for vectorized memcmp comparisons."""
    k = np.ascontiguousarray(keys)
    return k.view([("k", f"S{k.shape[1]}")])["k"].reshape(-1)


class ModelPartitioner:
    """Learned-model equi-depth partitioner (paper §3.3): bucket =
    ``min(floor(F(key) * P), P - 1)`` under the trained CDF model."""

    kind = "model"

    def __init__(self, model: rmi.RMIParams, n_partitions: int):
        self.model = model
        self.n_partitions = int(n_partitions)

    def bucket_np(self, keys: np.ndarray) -> np.ndarray:
        hi, lo = encoding.encode_np(keys)
        return rmi.predict_bucket_np(self.model, hi, lo, self.n_partitions)


class SplitterPartitioner:
    """Sample-splitter (quantile) partitioner: partition j holds keys in
    ``[b_j, b_{j+1})`` for deduplicated sample quantile boundaries — the
    SampleSort fallback of the hybrid planner.  Monotone by construction
    (``searchsorted`` over sorted boundaries)."""

    kind = "splitter"

    def __init__(self, boundaries: np.ndarray):
        # (B, K) u8 strictly-increasing boundary keys; P = B + 1
        self.boundaries = np.ascontiguousarray(boundaries, dtype=np.uint8)
        self._bounds = _keys_sview(self.boundaries)
        self.n_partitions = int(self.boundaries.shape[0]) + 1

    def bucket_np(self, keys: np.ndarray) -> np.ndarray:
        # side="right": a key equal to b_j lands in partition j + 1, so
        # every boundary key starts its own partition (exact dup splits)
        return np.searchsorted(
            self._bounds, _keys_sview(keys), side="right"
        ).astype(np.int32)


def splitter_boundaries(
    sample_keys: np.ndarray, n_partitions: int
) -> np.ndarray:
    """(B, K) u8 deduplicated equi-depth quantile boundaries from the
    sample (B <= n_partitions - 1; duplicate quantiles collapse, so a
    duplicate flood yields fewer — never overlapping — partitions)."""
    if sample_keys.shape[0] == 0 or n_partitions <= 1:
        return np.empty((0, sample_keys.shape[1]), dtype=np.uint8)
    sview = _keys_sview(sample_keys)
    order = np.argsort(sview, kind="stable")
    n = sample_keys.shape[0]
    ranks = (np.arange(1, n_partitions, dtype=np.int64) * n) // n_partitions
    picks = order[np.clip(ranks, 0, n - 1)]
    bounds = np.ascontiguousarray(sample_keys[picks], dtype=np.uint8)
    bview = _keys_sview(bounds)
    keep = np.concatenate([[True], bview[1:] != bview[:-1]])
    # a boundary equal to the global minimum splits nothing: partition 0
    # would be guaranteed empty (side="right" sends the min to bucket 1)
    keep &= bview > sview[order[0]]
    return bounds[keep]


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


def diagnose(
    sample_keys: np.ndarray, model: rmi.RMIParams | None = None
) -> SampleDiagnostics:
    """Cheap sample statistics (one sort of the sample, O(n log n)).

    ``sortedness``/``mean_run_length`` read the sample in the order given
    (``fmt.sample_keys`` returns contiguous input-order runs, so they
    reflect input sortedness); the remaining statistics are
    permutation-stable.
    """
    n = int(sample_keys.shape[0])
    if n == 0:
        return SampleDiagnostics()
    sview = _keys_sview(sample_keys)
    if n == 1:
        asc_frac, run_len = 1.0, 1.0
    else:
        asc = sview[1:] >= sview[:-1]
        asc_frac = float(asc.mean())
        run_len = n / (int((~asc).sum()) + 1)
    cardinality = int(np.unique(sview).shape[0])
    cdf_err = 0.0
    if model is not None:
        order = np.argsort(sview, kind="stable")
        hi, lo = encoding.encode_np(sample_keys[order])
        pred = rmi.predict_cdf_np(model, hi, lo).astype(np.float64)
        emp = (np.arange(n, dtype=np.float64) + 0.5) / n
        cdf_err = float(np.abs(pred - emp).max())
    return SampleDiagnostics(
        n_sample=n,
        sortedness=asc_frac,
        mean_run_length=float(run_len),
        dup_ratio=1.0 - cardinality / n,
        cardinality=cardinality,
        cdf_err=cdf_err,
    )


# ---------------------------------------------------------------------------
# Decision + knob tuning
# ---------------------------------------------------------------------------


def choose_partitioner(
    diag: SampleDiagnostics,
    n_partitions: int,
    cfg: PlannerConfig | None = None,
) -> tuple[str, str]:
    """(decision, reason): ``model`` unless a diagnostic disqualifies it."""
    cfg = cfg or PlannerConfig()
    if cfg.partitioner not in ("auto", "model", "splitter"):
        raise ValueError(
            f"unknown partitioner {cfg.partitioner!r} "
            "(expected auto|model|splitter)"
        )
    if cfg.partitioner != "auto":
        return cfg.partitioner, "forced by configuration"
    if diag.n_sample == 0:
        return "model", "empty sample (nothing to diagnose)"
    if diag.cardinality <= cfg.tiny_universe:
        return (
            "splitter",
            f"tiny key universe (sample cardinality {diag.cardinality} <= "
            f"{cfg.tiny_universe}): exact quantile boundaries beat a "
            f"float CDF",
        )
    skew = diag.cdf_err * max(n_partitions, 1)
    if skew > cfg.max_partition_skew:
        return (
            "splitter",
            f"model mispartitions: cdf_err {diag.cdf_err:.3f} x "
            f"{n_partitions} partitions = est. worst-partition skew "
            f"{skew:.1f} > {cfg.max_partition_skew}",
        )
    return "model", (
        f"model CDF fits the sample (cdf_err {diag.cdf_err:.3f}, est. "
        f"skew {skew:.1f} <= {cfg.max_partition_skew})"
    )


def tune_knobs(
    *,
    file_bytes: int,
    memory_budget_bytes: int,
    n_readers: int = 1,
    cardinality: int = 0,
    explicit_partitions: int = 0,
    explicit_flush: int = 0,
    explicit_segments: int = 0,
    explicit_writers: int = 0,
) -> TunedKnobs:
    """Auto-tune ``n_partitions`` / ``flush_bytes`` / ``batch_segments``
    / ``n_writers`` from the budget and the sample; explicit (non-zero)
    values win."""
    part_target = max(memory_budget_bytes // 4, _PART_BYTES_FLOOR)
    n_partitions = explicit_partitions or max(
        1, -(-int(file_bytes) // part_target)
    )
    if not explicit_partitions and cardinality > 0:
        # partitions beyond the distinct-key count are guaranteed empty
        n_partitions = max(1, min(n_partitions, cardinality))
    # spill buffers: a fair share of the budget per reader per partition,
    # floored so fragments stay seek-amortizing and capped at the
    # historical 1 MB coalescing threshold
    flush = explicit_flush or int(
        np.clip(
            memory_budget_bytes
            // (4 * max(n_readers, 1) * min(max(n_partitions, 1), 64)),
            MIN_FLUSH_BYTES,
            MAX_FLUSH_BYTES,
        )
    )
    segments = explicit_segments or max(
        1, min(MAX_BATCH_SEGMENTS, n_partitions)
    )
    # writer-pool width (DESIGN.md §15): positioned writes are
    # embarrassingly parallel (§3.5), but extra writers only pay when
    # the sort round-trips real storage — i.e. under spill pressure,
    # when the corpus overflows the RAM spill budget (half the memory
    # budget) and output writeback competes with spill re-reads.  Under
    # pressure scale with the partition count up to MAX_WRITERS; without
    # it two writers suffice to hide the occasional writeback stall.
    spill_pressure = file_bytes > memory_budget_bytes // 2
    writers = explicit_writers or min(
        max(n_partitions, 1), MAX_WRITERS if spill_pressure else 2
    )
    return TunedKnobs(
        n_partitions=int(n_partitions),
        flush_bytes=int(flush),
        batch_segments=int(min(max(segments, 1), MAX_BATCH_SEGMENTS)),
        n_writers=int(max(writers, 1)),
    )


def plan_sort(
    sample_keys: np.ndarray,
    model: rmi.RMIParams,
    *,
    file_bytes: int,
    memory_budget_bytes: int,
    n_readers: int = 1,
    explicit_partitions: int = 0,
    explicit_flush: int = 0,
    explicit_segments: int = 0,
    explicit_writers: int = 0,
    planner_cfg: PlannerConfig | None = None,
) -> SortPlan:
    """The full pre-sort plan: diagnose -> choose -> tune -> build."""
    planner_cfg = planner_cfg or PlannerConfig()
    diag = diagnose(sample_keys, model)
    knobs = tune_knobs(
        file_bytes=file_bytes,
        memory_budget_bytes=memory_budget_bytes,
        n_readers=n_readers,
        cardinality=diag.cardinality,
        explicit_partitions=explicit_partitions,
        explicit_flush=explicit_flush,
        explicit_segments=explicit_segments,
        explicit_writers=explicit_writers,
    )
    decision, reason = choose_partitioner(
        diag, knobs.n_partitions, planner_cfg
    )
    if decision == "splitter":
        bounds = splitter_boundaries(sample_keys, knobs.n_partitions)
        part = SplitterPartitioner(bounds)
        # deduplication may have collapsed quantiles: the spill/loader
        # plumbing sizes itself from the *actual* partition count
        knobs = dataclasses.replace(
            knobs, n_partitions=part.n_partitions
        )
    else:
        part = ModelPartitioner(model, knobs.n_partitions)
    return SortPlan(
        decision=decision,
        reason=reason,
        diagnostics=diag,
        partitioner=part,
        knobs=knobs,
    )


def preplanned(
    model: rmi.RMIParams,
    *,
    n_partitions: int,
    file_bytes: int,
    memory_budget_bytes: int,
    n_readers: int = 1,
    explicit_flush: int = 0,
    explicit_segments: int = 0,
    explicit_writers: int = 0,
) -> SortPlan:
    """Plan for a sort under a pre-trained shared model (co-partitioned
    multi-input sorts, DESIGN.md §9): the partitioner MUST be the shared
    model — a splitter would break partition alignment — and
    ``n_partitions`` is the caller's shared value.  Only the spill,
    batch, and writer knobs are tuned."""
    knobs = tune_knobs(
        file_bytes=file_bytes,
        memory_budget_bytes=memory_budget_bytes,
        n_readers=n_readers,
        explicit_partitions=max(n_partitions, 1),
        explicit_flush=explicit_flush,
        explicit_segments=explicit_segments,
        explicit_writers=explicit_writers,
    )
    return SortPlan(
        decision="model",
        reason="pre-trained shared model (co-partitioned sort)",
        diagnostics=SampleDiagnostics(),
        partitioner=ModelPartitioner(model, knobs.n_partitions),
        knobs=knobs,
    )
