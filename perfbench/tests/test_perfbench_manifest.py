"""BENCHMARK.json keeps to the benchmark's contract, and every name in
it resolves to its file."""

import json
import re

import pytest

from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = manifest.load()
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert (manifest.ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names_are_in_the_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith("perfbench/")
    data = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert NAME.match(key) and key in data
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    cell = manifest.cell(BENCH, w["name"])
    assert cell.traffic["sizes"] and max(cell.traffic["sizes"]) <= cell.config["records_per_call_max"]
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
