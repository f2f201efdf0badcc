"""Data meshes over ``torch.distributed`` (port of
``src/repro/launch/mesh.py``).

The reference is single-controller SPMD: one process runs one
``shard_map`` program over a jax mesh of every device.  The port keeps
its semantics and moves them onto ranks, PyTorch's idiom of one process
per rank over a process group:

* rank ``r`` owns device ``cuda:r % device_count()``, or the CPU when
  the caller asks for it;
* rank ``r`` holds shard ``r`` of every globally shaped array;
* each ``lax.all_to_all(..., tiled=True)`` is one
  :meth:`DataMesh.all_to_all` with equal splits;
* a process with no process group is a 1-device mesh (world size 1).

The sorter's meshes are 1-D ``("data",)`` :class:`DataMesh`es.  The LM
step's meshes are DTensor ``DeviceMesh``es of any rank over the current
process group (:func:`make_device_mesh`): ``("data", "model")`` for
training, and the pod shapes of :func:`make_production_mesh` — 256 GPU
ranks on a 16 x 16 ``("data", "model")`` mesh, 512 on a 2 x 16 x 16
``("pod", "data", "model")`` one — which the dry run builds over a fake
process group in one process.

On one card NCCL runs at world size 1 only (it puts no two ranks on one
GPU); several ranks sharing a card use gloo, named explicitly, which
takes the card's tensors itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# A rank that fails leaves its peers waiting in the next collective for
# at most this long (torch's own default for gloo).
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of a 1-D data mesh: the process group (``None``
    for a single process without one), this process's rank, the world
    size and the rank's device.  ``shape[axis]`` is the world size, so
    code shaped like the reference's reads the same."""

    group: "dist.ProcessGroup | None"
    rank: int
    world_size: int
    device: torch.device
    axis_names: tuple = ("data",)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.world_size}

    def check_axes(self, axis_names) -> None:
        """Entry points take the reference's ``axis_names``; on a 1-D
        mesh they can only name its one axis."""
        if tuple(axis_names) != self.axis_names:
            raise ValueError(
                f"axis_names {tuple(axis_names)} do not name this mesh's "
                f"axes {self.axis_names}"
            )

    @property
    def backend(self) -> "str | None":
        return None if self.group is None else dist.get_backend(self.group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block ``j`` of ``x`` (split evenly along dim 0) goes to rank
        ``j``; block ``i`` of the result came from rank ``i``: jax's
        ``all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``."""
        if self.group is None:
            return x
        if x.shape[0] % self.world_size:
            raise ValueError(
                f"all_to_all: {x.shape[0]} rows do not split evenly over "
                f"{self.world_size} ranks"
            )

        def run(out, inp):
            dist.all_to_all_single(out, inp, group=self.group)

        return _exchange(x, run, x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(world_size, *x.shape)``: every rank's ``x`` in rank order."""
        if self.group is None:
            return x[None]

        def run(out, inp):
            dist.all_gather(list(out.unbind(0)), inp, group=self.group)

        return _exchange(x, run, (self.world_size, *x.shape))

    def all_gather_ints(self, values) -> np.ndarray:
        """``(world_size, len(values))`` int64 host array of every rank's
        ``values``: the counts the ranks agree on."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(list(values), dtype=torch.int64, device=dev)
        return self.all_gather(t).cpu().numpy()

    def barrier(self) -> None:
        self.all_gather_ints([0])


def _exchange(x: torch.Tensor, run, out_shape) -> torch.Tensor:
    """``run(out, inp)`` into a new ``out_shape`` tensor beside ``x``."""
    x = x.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    run(out, x)
    return out


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` owns: ``cuda:rank % device_count()``, or
    the CPU when ``device`` asks for it (a CUDA device must exist)."""
    from repro_torch.core.executor import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_data_mesh(n_dev: "int | None" = None, *, device="cuda") -> DataMesh:
    """1-D ``("data",)`` mesh over every rank of the default process
    group, or a 1-device mesh in a process without one — the topology
    the distributed sorter and the mesh executor assume.  ``n_dev``, if
    given, must be the world size: a rank cannot address devices of
    other processes."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    n = world if n_dev is None else n_dev
    if n != world:
        raise ValueError(
            f"requested {n} devices, the process group has {world} ranks "
            "(start one process per rank, e.g. torchrun --nproc-per-node "
            f"{n}, and call initialize_multiprocess first)"
        )
    dev = rank_device(rank, device)
    if group is not None and dist.get_backend(group) == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group needs device='cuda'")
    return DataMesh(group, rank, world, dev)


def make_mesh(shape: tuple, axes: tuple, *, device="cuda"):
    """A mesh named ``axes`` of ``shape``: a 1-D :class:`DataMesh` (the
    sorter's), or a ``DeviceMesh`` (:func:`make_device_mesh`) for more
    axes."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axes)}")
    if len(shape) == 1:
        return dataclasses.replace(
            make_data_mesh(shape[0], device=device), axis_names=tuple(axes)
        )
    return make_device_mesh(shape, axes, device=device)


def make_device_mesh(shape: tuple, axes: tuple, *, device="cuda"):
    """A DTensor ``DeviceMesh`` of ``shape`` named ``axes`` over every rank
    of the current process group (real ranks or the ``"fake"`` backend),
    ranks in row-major order.  The shape's product must be the world
    size; a process without a process group is world size 1."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} ranks, the process group has "
            f"{world} (start one process per rank and call "
            "initialize_multiprocess first)"
        )
    if not dist.is_initialized():
        raise ValueError(
            "a DeviceMesh needs a process group: call initialize_multiprocess "
            "(world size 1 included)"
        )
    dev = rank_device(dist.get_rank(), device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 = 256 ranks over ``("data", "model")``; 2 x 16 x 16 = 512
    over ``("pod", "data", "model")`` when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device=device)


def init_fake_process_group(world_size: int) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks in this one
    process (this process is rank 0): collectives return at once and move
    nothing.  The dry run traces a pod-sized step over it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def initialize_multiprocess(
    init_method: "str | None" = None,
    world_size: "int | None" = None,
    rank: "int | None" = None,
    *,
    backend: "str | None" = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Multi-process entry point: an idempotent wrapper over
    ``torch.distributed.init_process_group``.

    Every rank calls it once, before :func:`make_data_mesh`.  Arguments
    are explicit (``init_method`` such as ``tcp://host:port`` or
    ``file:///shared/path``, ``world_size``, ``rank``) or come from
    ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  ``backend`` defaults to NCCL for ``device="cuda"``
    and gloo for ``"cpu"``; name ``"gloo"`` to run several ranks on one
    card.  Under NCCL the rank's card becomes the current device.  A
    single process with no arguments and no ``torchrun`` environment is
    left alone: it is a 1-device mesh.  ``timeout_s`` bounds how long a
    collective waits for a rank that failed."""
    if dist.is_initialized():
        return  # already initialized — a second init would raise
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size in (None, 1):
        return  # single-process topology: nothing to initialize
    if init_method is None:
        init_method = "env://"
    if rank is None:
        rank = int(env["RANK"])
    dev = rank_device(rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs device='cuda'")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def exit_rank(status: int = 0) -> None:
    """End a rank's process: destroy its process group, flush its output
    and leave without the interpreter's teardown, in which torch's gloo
    backend can abort ("terminate called without an active exception",
    exit -6) after a clean run: 4 of 10 eight-rank CPU jobs did so with
    torch 2.13.0+cpu, none with this exit."""
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(status)


def spawn(
    code: str,
    world_size: int,
    *,
    env: "dict | None" = None,
    timeout_s: float = 120.0,
) -> list[str]:
    """Run ``python -c code`` in ``world_size`` processes at once, with
    ``RANK`` and ``WORLD_SIZE`` set as ``torchrun`` sets them, and return
    each rank's standard output.  The code brings up its own process
    group (:func:`initialize_multiprocess`) and ends with
    :func:`exit_rank`.  A rank that exits non-zero,
    or a run that outlives ``timeout_s``, kills every rank and raises
    ``RuntimeError`` with that rank's error output."""
    base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world_size)}
    outs, errs, procs = [], [], []
    try:
        for r in range(world_size):
            outs.append(tempfile.TemporaryFile())
            errs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=outs[r], stderr=errs[r],
                env={**base, "RANK": str(r)},
            ))
        deadline = time.monotonic() + timeout_s
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exited with {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                r = codes.index(None)
                failed = (r, f"still running after {timeout_s} s")
            else:
                time.sleep(0.05)
        if failed is not None:
            r, why = failed
            tails = []
            for f in (outs[r], errs[r]):
                f.seek(0)
                tails.append(f.read().decode(errors="replace")[-3000:])
            raise RuntimeError(
                f"rank {r} of {world_size} {why}:\n" + "\n".join(tails)
            )
        res = []
        for f in outs:
            f.seek(0)
            res.append(f.read().decode())
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs + errs:
            f.close()
