"""ELSAR: the out-of-core, file-to-file external sort (paper Alg. 1) — the
port's entry point (port of ``src/repro/core/external.py``).

The runtime lives in ``repro_torch.core.pipeline``: Sample → Train →
Plan → Partition on the host, the Sort stage on the configured device
(by default the CUDA card, through the encode, RMI and bitonic
kernels), then positioned parallel writes.
"""

from __future__ import annotations

from repro_torch.core.config import SortConfig, coerce_sort_config
from repro_torch.core.pipeline import SortPipelineConfig, SortStats, run_pipeline

__all__ = ["SortConfig", "SortStats", "SortPipelineConfig", "sort_file"]


def sort_file(
    input_path: str,
    output_path: str,
    config: "SortConfig | None" = None,
    **overrides,
) -> SortStats:
    """Sort a record file with ELSAR; returns instrumentation stats.

    The call shape and every knob are the reference's
    (``repro.core.external.sort_file``): ``sort_file(input, output,
    config=SortConfig(...), **overrides)``, with bare legacy keywords
    accepted through :func:`repro_torch.core.config.coerce_sort_config`.
    ``SortConfig.device`` picks where the Sort stage runs: ``"cuda"``
    (the default; raises when no GPU is present) or ``"cpu"``.  On the
    card, ``executor="auto"`` runs the batched executor on the grid
    graph with the CUDA kernels; on the CPU it resolves as the
    reference does on its CPU backend.  Output is byte-identical across
    devices, executors, reader counts and writer widths.
    ``manifest=True`` also writes ``<output>.manifest.npz``, the learned
    index that ``repro_torch.serve.index.SortedFileIndex`` serves; its
    layout is the reference's, so either package loads it.
    ``model_cache`` is not ported yet and raises ``NotImplementedError``.
    """
    cfg = coerce_sort_config(config, overrides)
    return run_pipeline(input_path, output_path, cfg.to_pipeline())
