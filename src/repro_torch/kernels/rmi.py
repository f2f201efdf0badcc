"""RMI kernel: fused two-level RMI inference -> equi-depth bucket id.

Replaces ``src/repro/kernels/rmi.py:rmi_bucket_pallas``.  The CUDA source
is ``csrc/rmi.cu``; its note says what bounds the kernel (memory: 16
bytes read and 4 written per record, plus leaf-row gathers that the L2
serves) and why the leaf tables stay in global memory at the main
path's leaf counts.  :func:`rmi_bucket_plain` is the plain PyTorch
version it is held against; both round every float step on its own and
saturate float -> int casts, so their ids agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import rmi
from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/rmi.cu"


def rmi_bucket_plain(
    params: rmi.RMIParams, hi: torch.Tensor, lo: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """(N,) int32 bucket ids in plain PyTorch."""
    return rmi.predict_bucket(params, hi, lo, n_buckets)


def _check_words(hi: torch.Tensor, lo: torch.Tensor) -> None:
    if not (hi.is_cuda and lo.is_cuda):
        raise ValueError("RMI kernel needs CUDA tensors")
    if hi.dtype != torch.int64 or lo.dtype != torch.int64:
        raise ValueError(f"key words must be int64, got {hi.dtype}/{lo.dtype}")
    if hi.ndim != 1 or hi.shape != lo.shape:
        raise ValueError(f"hi/lo must be equal 1-D shapes, got {hi.shape}/{lo.shape}")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("hi/lo must be contiguous")


def rmi_bucket_cuda(
    params: rmi.RMIParams, hi: torch.Tensor, lo: torch.Tensor, n_buckets: int
) -> torch.Tensor:
    """(N,) int32 bucket ids by the kernel; ``params`` leaves must lie on
    ``hi``'s device (``RMIParams.to``)."""
    _check_words(hi, lo)
    if params.device != hi.device:
        raise ValueError(f"model on {params.device}, keys on {hi.device}")
    if not 1 <= n_buckets < 2**31:
        raise ValueError(f"n_buckets {n_buckets} outside [1, 2**31)")
    ftable, utable = params.kernel_tables
    out = torch.empty(hi.shape[0], dtype=torch.int32, device=hi.device)
    lib = build.library()
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_rmi_bucket(
            hi.data_ptr(), lo.data_ptr(), hi.shape[0],
            int(params.min_hi), int(params.min_lo),
            float(params.inv_range), float(params.root_slope),
            float(params.root_intercept), int(n_buckets),
            ftable.data_ptr(), utable.data_ptr(), params.n_leaf,
            out.data_ptr(), stream,
        )
    build.check(code, "RMI kernel")
    return out
