"""Shared tiny cells for the benchmark's CPU tests."""

import copy

import pytest

from perfbench import manifest

# sizes a CPU run holds: a 2**16-record file, 256 leaves, three sizes
TINY_CONFIG = {"file_records": 1 << 16, "records_per_call_max": 1 << 14, "n_leaf": 256}
TINY_TRAFFIC = {"sizes": [4096, 8192, 16384]}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell of BENCHMARK.json, cut to CPU size."""
    bench = manifest.load()

    def make(name: str) -> manifest.Cell:
        cell = copy.deepcopy(manifest.cell(bench, name))
        cell.config.update(TINY_CONFIG)
        cell.traffic.update(TINY_TRAFFIC)
        return cell

    return make
