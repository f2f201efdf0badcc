"""Stage modules of the pipelined ELSAR runtime (DESIGN.md §1, §10).

Copy of ``src/repro/core/stages/__init__.py`` for the PyTorch port.

One module per stage of the Sample→Train→Partition→Sort→Write graph,
plus the shared plumbing:

* :mod:`repro_torch.core.stages.stats`  — ``SortStats`` / ``PhaseClock``
* :mod:`repro_torch.core.stages.queues` — bounded-queue put/get + ``Abort``
* :mod:`repro_torch.core.stages.reader` — striped reader pool + ``PartitionSpill``
* :mod:`repro_torch.core.stages.loader` — eager fragment drain / block parsing
* :mod:`repro_torch.core.stages.sorter` — queue→``SortExecutor`` stream adapter
* :mod:`repro_torch.core.stages.writer` — zero-copy parallel positioned writes

The orchestrator (``repro_torch.core.pipeline.run_pipeline``) wires them
together; the sort implementation itself lives behind the
``repro_torch.core.executor.SortExecutor`` seam.
"""

from repro_torch.core.stages.loader import loader_worker
from repro_torch.core.stages.queues import Abort, get, put
from repro_torch.core.stages.reader import (
    PartitionSpill,
    SpillBudget,
    reader_worker,
    spill_root,
)
from repro_torch.core.stages.sorter import sorter_worker
from repro_torch.core.stages.stats import (
    LatencyReservoir,
    PhaseClock,
    ServeStats,
    SortStats,
)
from repro_torch.core.stages.writer import WriterPool, writer_worker

__all__ = [
    "Abort",
    "LatencyReservoir",
    "PartitionSpill",
    "PhaseClock",
    "ServeStats",
    "SpillBudget",
    "SortStats",
    "WriterPool",
    "get",
    "loader_worker",
    "put",
    "reader_worker",
    "sorter_worker",
    "spill_root",
    "writer_worker",
]
