"""Warm-start model cache: amortize Sample→Train across sorts (port of
``src/repro/core/model_cache.py``; DESIGN.md §12).

Training is pure overhead when the incoming corpus is distributed like
one the process has already sorted.  :class:`ModelCache` keeps recently
trained :class:`~repro_torch.core.rmi.RMIParams` keyed by their
manifest-v3 ``model_hash`` and answers lookups with the **planner's own
trust criterion**: a cached model is reused iff the fresh sample's CDF
error against it keeps the estimated worst-partition skew
(``cdf_err * n_partitions``) inside the planner's band.  A drifted
corpus fails the band check and retrains — the cache can change *which*
model partitions, never the sorted bytes.

``model_hash`` hashes the model in the reference's dtypes
(``manifest.model_hash``), so a model gets the same key in both
packages.  Entries are the models as trained, on the CPU, where the
host stages read them.  ``RMIParams.to`` keeps the copy it uploads on
the model it was called on, so a hit sorts on the card with the leaf
tables (and packed kernel table) the entry's first sort uploaded.

The cache is in-process and thread-safe; pass one instance to
consecutive ``external.sort_file(model_cache=...)`` calls.  Hit/miss
totals live on the cache, the per-sort outcome and model hash land on
``SortStats``.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from repro_torch.core import manifest, planner, rmi


class ModelCache:
    """LRU cache of trained CDF models keyed by ``model_hash``."""

    def __init__(
        self,
        max_entries: int = 8,
        planner_cfg: "planner.PlannerConfig | None" = None,
    ):
        self.max_entries = max(1, int(max_entries))
        self.planner_cfg = planner_cfg or planner.PlannerConfig()
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, rmi.RMIParams]" = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(
        self, sample_keys: np.ndarray, n_partitions: int
    ) -> "tuple[rmi.RMIParams | None, str]":
        """Return ``(model, model_hash)`` for the most-recently-used
        cached model the fresh sample trusts, or ``(None, "")``.

        Trust = the planner band: ``diagnose(sample, model).cdf_err *
        n_partitions <= max_partition_skew`` — the same threshold that
        would route a *freshly trained* model to the splitter fallback,
        so a cache hit is never a model the planner would distrust.
        """
        with self._lock:
            candidates = list(reversed(self._entries.items()))  # MRU first
        if sample_keys.shape[0] == 0:
            candidates = []
        for model_hash, model in candidates:
            diag = planner.diagnose(sample_keys, model)
            skew = diag.cdf_err * max(int(n_partitions), 1)
            if skew <= self.planner_cfg.max_partition_skew:
                with self._lock:
                    if model_hash in self._entries:
                        self._entries.move_to_end(model_hash)
                    self.hits += 1
                return model, model_hash
        with self._lock:
            self.misses += 1
        return None, ""

    def store(self, model: rmi.RMIParams) -> str:
        """Insert (or refresh) a freshly trained model; returns its
        manifest-v3 ``model_hash``.  Evicts least-recently-used entries
        beyond ``max_entries``."""
        model_hash = manifest.model_hash(model)
        with self._lock:
            self._entries[model_hash] = model
            self._entries.move_to_end(model_hash)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return model_hash
