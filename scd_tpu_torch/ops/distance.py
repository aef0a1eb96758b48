"""Pairwise distance + E-step assignment.

Port of ``scd_tpu/ops/distance.py``.  Squared euclidean distances use the
matmul expansion ``|x|^2 - 2 x·c^T + |c|^2`` in f32 (TF32 off, see
``core/device.py``), clamped at 0.  k-means++, the SSKM labelled sums and
the fused-EM plain version use these plain pieces.

:func:`estep_assign` dispatches by device: a CUDA tensor runs the
hand-written kernel (``csrc/estep.cu``, replacing the TPU kernel
``scd_tpu/ops/pallas_kernels.py::estep_assign_pallas``), a CPU tensor runs
:func:`estep_assign_plain`.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scd_tpu_torch.ops import build


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, K] between rows of x [N, D] and
    c [K, D], clamped at 0 against the expansion's cancellation."""
    x = x.float()
    c = c.float()
    x_sq = (x * x).sum(dim=-1, keepdim=True)  # [N, 1]
    c_sq = (c * c).sum(dim=-1)[None, :]  # [1, K]
    cross = torch.matmul(x, c.t())  # [N, K]
    return torch.clamp_min(x_sq - 2.0 * cross + c_sq, 0.0)


def estep_assign(x: torch.Tensor, c: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (labels [N] int32, min_sqdist [N] f32);
    ties go to the first center."""
    if x.is_cuda:
        return estep_assign_cuda(x.float().contiguous(),
                                 c.to(x.device).float().contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"estep_assign: unsupported device {x.device}")
    return estep_assign_plain(x, c)


def estep_assign_plain(x: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on any device: the JAX package's XLA
    ``estep_assign`` (clamped pairwise distances, then the first min)."""
    d = pairwise_sqdist(x, c)
    mindist, labels = torch.min(d, dim=1)
    return labels.to(torch.int32), mindist


def estep_assign_cuda(x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  x [N, D] f32 and c [K, D] f32, contiguous on one
    CUDA device, K >= 1.  Returns (labels [N] int32, mindist [N] f32) with
    the kernel's arithmetic: min over j of |c_j|^2 - 2 x·c_j, then
    max(min + |x|^2, 0).  Counts its launches in
    ``estep_assign_cuda.launches``."""
    dev = x.device
    if not (x.is_cuda and c.device == dev):
        raise ValueError("estep_assign_cuda takes CUDA tensors on one device")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"estep_assign_cuda takes f32, got {x.dtype} / "
                        f"{c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, c {tuple(c.shape)} do "
                         f"not match")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("estep_assign_cuda takes contiguous tensors")
    n, d = x.shape
    k = c.shape[0]
    if k < 1 or d < 1:
        raise ValueError(f"empty centers {tuple(c.shape)}")
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mindist = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return labels, mindist
    lib = build.load("estep")
    fn = lib.estep_assign_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)
    csq = torch.empty(k, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), c.data_ptr(), n, d, k, labels.data_ptr(),
                mindist.data_ptr(), csq.data_ptr(), stream)
    build.check(rc, "estep_assign")
    estep_assign_cuda.launches += 1
    return labels, mindist


estep_assign_cuda.launches = 0
