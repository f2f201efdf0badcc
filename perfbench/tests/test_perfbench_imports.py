"""Nothing a run loads is JAX or the JAX package, and a run without a
CUDA card exits non-zero with no result."""

import ast
import json
import subprocess
import sys

from perfbench import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_names_are_compared_whole():
    mods = ["repro_torch.core", "reprox", "jaxlib.xla", "numpy", "repro", "flax.linen"]
    assert harness.forbidden_modules(mods) == ["flax", "jaxlib", "repro"]
    assert harness.forbidden_modules(["repro_torch", "jax_like"]) == []


def test_no_source_of_the_benchmark_imports_them():
    for path in manifest.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_a_whole_cpu_run_loads_none_of_them(tmp_path):
    code = f"""
import sys, time, json
sys.path[:0] = [{str(manifest.ROOT)!r}, {str(manifest.ROOT / 'src')!r}]
from perfbench import harness, manifest
cell = manifest.cell(manifest.load(), "gensort-skew.hbm-arrays")
cell.config.update(file_records=1 << 16, records_per_call_max=1 << 14, n_leaf=256)
cell.traffic.update(sizes=[4096])
r = harness.run_cell(cell, 5, 0.2, True, device="cpu", t_start=time.perf_counter())
for m in cell.end_to_end + cell.per_layer:
    manifest.reader(m["name"])
print(json.dumps({{"correct": r["correct"], "loaded": harness.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "loaded": []}


def test_run_without_a_card_exits_non_zero_with_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload", "gensort-skew.hbm-arrays",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
