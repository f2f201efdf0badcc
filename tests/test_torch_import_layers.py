"""Layering of the port: the kernel layer (``repro_torch.kernels``) is
built on by the glue in ``repro_torch.core`` and never imports it back.
The imports of every module under ``src/repro_torch/kernels/`` are read
with ``ast`` (nothing is imported), those inside functions included."""

import ast
from pathlib import Path

KERNELS = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels"
UPPER = {"partition", "learned_sort", "executor", "distributed",
         "terasort", "pipeline", "operators"}


def _upper_imports(source: str, package: str) -> list[str]:
    """The ``repro_torch.core`` modules of :data:`UPPER` that ``source``,
    a module of ``package``, imports, written as absolute names."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.split(".")[: len(package.split("."))
                                              - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            parts = name.split(".")
            if parts[:2] == ["repro_torch", "core"] and len(parts) > 2 \
                    and parts[2] in UPPER:
                found.append(".".join(parts[:3]))
    return sorted(set(found))


def test_kernels_import_no_core_glue():
    pkg = "repro_torch.kernels"
    # the reader itself sees each spelling of such an import
    for bad in ("from repro_torch.core import partition",
                "import repro_torch.core.executor as ex",
                "def f():\n    from ..core.learned_sort import sort_device",
                "from ..core import terasort"):
        assert _upper_imports(bad, pkg), bad
    assert not _upper_imports(
        "from repro_torch.core import encoding, rmi", pkg)
    modules = sorted(KERNELS.glob("*.py"))
    assert len(modules) >= 8, modules
    offenders = {
        m.name: got for m in modules
        if (got := _upper_imports(m.read_text(), pkg))
    }
    assert not offenders, offenders
