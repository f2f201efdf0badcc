#!/usr/bin/env python3
"""Chosen paths of ``chip_smoke.py``'s LM phase (phase 11), alone, on one
CUDA card: ``a`` qwen3-4b, ``b`` 2-layer mixtral, ``d`` one period of
jamba, ``e`` xlstm-350m, ``f`` whisper-medium, ``c`` the ten archs at
smoke size card against host; each under ``torch.inference_mode()``, as
phase 11 serves.  ``train``: the LM training phase (phase 12) whole, or
with ``--train-runs KEYS`` only the full-size runs named (``de``: xlstm
and whisper) before its smoke-size part; ``mesh``: the sharded LM step's
phase (phase 13) whole; ``mesh-a``: its (a) step and batch-1 check
alone, in a rank spawned as the phase spawns it; ``examples``: the
examples phase (phase 14) whole.

- ``--measure``: the served-vs-forward tolerances of the paths run are
  lifted, so that ``lm_check`` logs the drift and judges nothing; how
  the tolerances in ``chip_smoke.py`` were set.
- ``--sums``: each traced serve also logs its device time as
  ``key_averages`` sums it, beside ``chip_smoke.device_time``'s sum
  over the raw trace (take paths whose launches ``key_averages`` gets
  through in minutes: ``b``, ``d``, ``f``).
- ``--parent DIR`` (an unpacked earlier tree of this repository): the
  paths run twice in turns, parent, this tree, this tree, parent, with
  the chunked attention (``models/attention._sdpa_chunked``) of DIR in
  place of this tree's: how a change of its blocks moves the
  served-vs-forward drift.  DIR's chunked attention takes causal
  self-attention only, so this reproduces the comparison on path ``b``
  alone (``d``'s attention is chunked too, but DIR cannot build jamba).
  With ``mesh-a``, DIR's phase 13 rank (its ``chip_smoke.mesh_rank`` on
  its own package) runs in turns with this tree's, against one plain
  reference step: how a change of the DTensor layouts moves (a)'s ms a
  step and collectives.

Run from the repository root:

    python3 experiments/lm_paths.py b d e f [--measure] [--sums] [--parent DIR]
    python3 experiments/lm_paths.py train [--train-runs abde]
    python3 experiments/lm_paths.py mesh
    python3 experiments/lm_paths.py mesh-a [--parent DIR]
    python3 experiments/lm_paths.py examples
"""

import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parent_chunked(parent: str):
    """DIR's ``_sdpa_chunked`` under this tree's signature."""
    spec = importlib.util.spec_from_file_location(
        "parent_attention",
        os.path.join(parent, "src", "repro_torch", "models", "attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def chunked(q, k, v, n_rep, *, causal=True, window=0):
        if not causal:
            raise ValueError("the parent's chunked attention is causal only")
        return mod._sdpa_chunked(q, k, v, n_rep, window=window)

    return chunked


def both_sums(cs):
    """``cs.device_time`` that also logs ``key_averages``' sum."""
    raw = cs.device_time

    def device_time(prof):
        busy, top = raw(prof)
        t = time.perf_counter()
        averaged = sum(getattr(e, "self_device_time_total", 0.0)
                       for e in prof.key_averages()) / 1e6
        cs.log(f"lm_paths: device time {busy:.6f} s over the raw trace, "
               f"{averaged:.6f} s by key_averages "
               f"({time.perf_counter() - t:.1f} s to average)")
        return busy, top

    cs.device_time = device_time


def mesh_turns(cs, torch, np, parent: str | None) -> None:
    """Phase 13 (a) and its batch-1 check alone: the plain reference step
    once, then a rank of this tree (and, given ``parent``, of DIR in turns:
    parent, this tree, this tree, parent), each logging its losses
    against the reference's, ms a step, collectives and batch-1 check."""
    import json
    import tempfile

    from repro_torch.launch import mesh as tmesh

    turns = [("this tree", ROOT)]
    if parent:
        turns = [("parent", parent), ("this tree", ROOT), ("this tree", ROOT),
                 ("parent", parent)]
    with tempfile.TemporaryDirectory(prefix="lm_paths_mesh_") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        ref = cs.mesh_single(torch, np, ref_path)
        torch.cuda.empty_cache()
        cs.log(f"lm_paths: mesh (a) plain step loss_total {ref['losses']}, ms a step "
               f"{[round(x, 1) for x in ref['ms']]}")
        for i, (name, root) in enumerate(turns):
            t = time.perf_counter()
            code = (f"import sys; sys.path[:0] = [{root!r}, {os.path.join(root, 'src')!r}]; "
                    "import chip_smoke; chip_smoke.mesh_rank()")
            outs = tmesh.spawn(code, 1, timeout_s=900, env={
                "MESH_STORE": os.path.join(tmp, f"store{i}"), "MESH_REF": ref_path,
                "MESH_CKPT": os.path.join(tmp, f"ck{i}"), "MESH_BACKEND": cs.MESH_BACKEND,
                "MESH_SHAPE": json.dumps(cs.MESH_SHAPE)})
            res = json.loads([x for x in outs[0].splitlines() if x.startswith("RANK ")][-1][5:])
            diff = max(abs(a - b) for a, b in zip(res["losses"], ref["losses"]))
            cs.log(f"lm_paths: mesh (a) {name}: loss_total {res['losses']} (largest "
                   f"difference {diff:.2e}), ms a step {[round(x, 1) for x in res['ms']]}, "
                   f"peak {res['peak_gb']:.2f} GB, collectives {json.dumps(res['collectives'])}, "
                   f"layouts {res['placements']}; batch 1 {json.dumps(res.get('batch1'))}; "
                   f"{time.perf_counter() - t:.1f} s")


def main() -> int:
    args = sys.argv[1:]
    measure = "--measure" in args
    sums = "--sums" in args
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    train_runs = args[args.index("--train-runs") + 1] if "--train-runs" in args else "abde"
    paths = [a for a in args if a in tuple("abcdef")]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.models import attention

    if not torch.cuda.is_available():
        print("lm_paths: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if measure:
        for name in ("LM_TOL_DEEP", "LM_TOL_SHALLOW", "LM_TOL_JAMBA", "LM_TOL_XLSTM",
                     "LM_TOL_WHISPER"):
            setattr(cs, name, float("inf"))
    if sums:
        both_sums(cs)
    turns = [("this tree", attention._sdpa_chunked)]
    if parent and paths:
        mine, theirs = attention._sdpa_chunked, parent_chunked(parent)
        turns = [("parent", theirs), ("this tree", mine), ("this tree", mine),
                 ("parent", theirs)]
    t0 = time.perf_counter()
    for name, chunked in turns:
        attention._sdpa_chunked = chunked
        for key in paths:
            t = time.perf_counter()
            with torch.inference_mode():
                if key == "c":
                    for arch in cs.LM_ARCHS:
                        cs.lm_cuda_vs_cpu(torch, np, arch)
                else:
                    getattr(cs, f"lm_{key}")(torch, np)
            cs.log(f"lm_paths: ({key}) with {name}'s chunked attention "
                   f"{time.perf_counter() - t:.1f} s")
    if "train" in args:
        cs.phase_train(torch, {k: {} for k in ("encode", "rmi_bucket", "sort_rows",
                                               "histogram")}, train_runs)
    if "mesh-a" in args:
        mesh_turns(cs, torch, np, parent)
    if "mesh" in args:
        cs.phase_mesh(torch, {k: {} for k in ("encode", "rmi_bucket", "sort_rows",
                                              "histogram")})
    if "examples" in args:
        cs.phase_examples(torch, {k: {} for k in ("encode", "rmi_bucket", "sort_rows",
                                                  "histogram")})
    cs.log(f"lm_paths: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
