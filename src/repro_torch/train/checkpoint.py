"""Checkpoints with atomic commit and elastic restore (port of
``src/repro/train/checkpoint.py``; the same on-disk layout).

Layout (one directory per step)::

    ckpt_dir/step_000123/
        manifest.json        # leaf names, files, shapes, dtypes, step
        proc00_leaf0000.npy  # this process's leaves
        ...
        COMMITTED            # written last, before the atomic rename — a
                             # checkpoint without it is ignored

A tree is a nested dict of tensors: a module's ``state_dict()`` or the
optimizer state (``{"step", "m": {...}, "v": {...}}``); a leaf's name is
its keys joined by ``/``.  bf16 leaves are stored as a 16-bit integer
view (``np.save`` has no bf16) and the manifest keeps the logical dtype.
The process index is the ``torch.distributed`` rank when a process group
is initialised, else 0.  Restore reads each leaf on the host and places
it on ``device`` (else the device of the matching leaf of ``like``), so a
checkpoint saved on the card restores on the CPU and the other way
round.

Sharded trees (DTensor leaves) are saved whole: every rank gathers each
leaf (``full_tensor()``), rank 0 alone writes and commits, as one process
of the reference does, and the others wait for the commit.  On restore a
DTensor leaf of ``like`` takes its value laid out as that leaf is — on
whatever mesh the run now has (the reference's elastic restore).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch



def _flatten(tree: dict, prefix: str = ""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flatten(leaf, f"{prefix}{key}/")
        else:
            yield prefix + key, leaf


def _unflatten(pairs) -> dict:
    out: dict = {}
    for name, leaf in pairs:
        *path, last = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def save(ckpt_dir: str, step: int, tree: dict) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if any(_is_dtensor(leaf) for _, leaf in _flatten(tree)):
        # every rank takes part in each leaf's gather; rank 0 writes
        pairs = ((n, leaf.full_tensor() if _is_dtensor(leaf) else leaf)
                 for n, leaf in _flatten(tree))
        if _process_index() == 0:
            _write(final, 0, step, pairs)
        else:
            for _ in pairs:
                pass
        torch.distributed.barrier()
        return final
    return _write(final, _process_index(), step, _flatten(tree))


def _write(final: str, proc: int, step: int, pairs) -> str:
    tmp = final + f".tmp{proc}"
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(pairs):
        t = leaf.detach().cpu()
        fname = f"proc{proc:02d}_leaf{i:04d}.npy"
        if t.dtype == torch.bfloat16:  # np.save has no bf16: a uint16 view
            store = t.view(torch.int16).numpy().view(np.uint16)
        else:
            store = t.numpy()
        np.save(os.path.join(tmp, fname), store)
        manifest["leaves"].append({
            "name": name,
            "file": fname,
            "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    open(os.path.join(tmp, "COMMITTED"), "w").close()
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, d, "COMMITTED")
        ):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _shard_like(t: torch.Tensor, like):
    """The host tensor ``t`` as a DTensor of ``like``'s mesh and
    placements: this rank's shard is sliced on the host and copied alone
    onto ``like``'s device, so no rank holds the whole leaf there."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, placements = like.device_mesh, like.placements
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    rows = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    local = torch.empty(shape, dtype=t.dtype, device=like.to_local().device).copy_(rows)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def restore(ckpt_dir: str, step: int, like: dict, device=None) -> dict:
    """A new tree of ``like``'s structure holding the checkpoint's leaves,
    on ``device`` (else each leaf of ``like``'s device); a leaf whose
    shape differs from ``like``'s raises."""
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    out = []
    for name, leaf in _flatten(like):
        meta = by_name[name]
        arr = np.load(os.path.join(d, meta["file"]))
        dtype = getattr(torch, meta["dtype"])
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(
                f"checkpoint/param shape mismatch at {name}: "
                f"{arr.shape} vs {tuple(leaf.shape)}"
            )
        if dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if _is_dtensor(leaf):
            t = _shard_like(t, leaf)
        else:
            t = t.to(device if device is not None else leaf.device)
        out.append((name, t))
    return _unflatten(out)
