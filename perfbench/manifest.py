"""``BENCHMARK.json`` and the files it names, each found by its name.

A cell ``<config>.<traffic>`` resolves to the configuration's file
(named in ``configs``), ``perfbench/traffic/<traffic>.json`` and, for
each of its metrics, ``perfbench/metrics/<metric>.py``.  A mix may name
the driver that runs its one-card cells, ``"driver": "<name>"``, found
as ``perfbench/drivers/<name>.py``; a mix without the key runs through
``harness.run_cell``.  Adding a cell, a mix, a metric or a new kind of
job (a driver) adds files and entries; no code here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries of its metrics
    per_layer: list


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; one of {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod  # for what looks itself up there (dataclasses)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` function of ``perfbench/metrics/<metric>.py``."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 "perfbench_metric_" + metric.replace(".", "_")).read


def driver(name: str, here: Path = HERE):
    """The module ``<here>/drivers/<name>.py``: its ``run(cell, seed,
    seconds, traced, *, device, t_start, sort=None) -> dict`` runs one
    one-card run of a cell and returns its result line; its ``PATHS``
    and ``sort_for(name)`` give the controls and planted faults that
    ``control.py`` puts in the program's place."""
    return _load(here / "drivers" / f"{name}.py", "perfbench_driver_" + name)


def runner(cell: Cell):
    """What runs one-card ``cell``: its mix's driver's ``run``, else
    ``harness.run_cell``."""
    name = cell.traffic.get("driver")
    if name is None:
        from perfbench import harness

        return harness.run_cell
    return driver(name).run
