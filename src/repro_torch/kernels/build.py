"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

One route for every kernel: ``nvcc`` compiles each source with a plain C
interface for ``sm_90a`` (one process per source, all started together),
links the objects into one shared library, and :func:`library` loads it
with ``ctypes``.  The build happens on first CUDA use, never at import,
into ``src/repro_torch/_build/`` (or ``$REPRO_TORCH_BUILD_DIR``), keyed by
a hash of the sources and flags so an edited source rebuilds.  The
library is published with an atomic rename, so concurrent first uses in
several processes never load a half-written file.

Every C entry point returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception — a kernel that fails to build or launch
raises, it never falls back to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("encode.cu", "rmi.cu", "bitonic.cu", "histogram.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _U, _F = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
    ctypes.c_float,
)
_SIGNATURES = {
    "repro_encode": (_I, [_P, _P, _P, _LL, _P]),
    "repro_encode_full": (_I, [_P, _LL, _I, _P, _P, _P, _LL, _P]),
    "repro_rmi_bucket": (
        _I, [_P, _P, _LL, _U, _U, _F, _F, _F, _I, _P, _I, _P, _P],
    ),
    "repro_sort_rows": (
        _I, [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _P],
    ),
    "repro_histogram": (_I, [_P, _LL, _I, _I, _I, _I, _I, _P, _P]),
    "repro_histogram_max_bins": (_I, [ctypes.POINTER(_I)]),
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
# what loading did: compiled or cached, seconds, path, and by source the
# ptxas lines naming each entry's registers and spills
build_info: dict = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR") or _PKG / "_build")


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build with the CUDA toolkit "
        "(set $NVCC or put nvcc on PATH)"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _ptxas_path(so: Path) -> Path:
    return so.with_name(so.name + ".ptxas.json")


def _compile(out: Path) -> dict[str, list[str]]:
    """Compile every source in parallel, link, and publish ``out`` with
    the ptxas resource lines of each source beside it (returned too)."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            objs.append(str(obj))
            procs.append(
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        logs = {}
        for src, p in zip(SOURCES, procs):
            log, _ = p.communicate()
            logs[src] = log
            if p.returncode != 0:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                        q.wait()
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        lib = Path(tmp) / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *objs],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        ptxas = {
            src: [
                ln.strip() for ln in log.splitlines()
                if any(w in ln for w in ("registers", "spill", "entry"))
            ]
            for src, log in logs.items()
        }
        side = Path(tmp) / "ptxas.json"
        side.write_text(json.dumps(ptxas))
        os.replace(side, _ptxas_path(out))
        os.replace(lib, out)
    return ptxas


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
            compiled = not so.exists()
            if compiled:
                ptxas = _compile(so)
            else:
                side = _ptxas_path(so)
                ptxas = json.loads(side.read_text()) if side.exists() else {}
            lib = ctypes.CDLL(str(so))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            build_info.update(
                compiled=compiled,
                seconds=time.perf_counter() - t0,
                path=str(so),
                ptxas=ptxas,
            )
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
