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


def masked_min_sum(mindist: torch.Tensor, n_valid) -> torch.Tensor:
    """Inertia over the valid rows: the first ``n_valid`` (a count, the
    rows beyond are padding) or, for a [N] 0/1 mask (a mesh's ragged
    pads, anywhere), the rows it marks."""
    if getattr(n_valid, "ndim", 0) == 1:
        valid = torch.as_tensor(n_valid, device=mindist.device).bool()
        return torch.where(valid, mindist, torch.zeros_like(mindist)).sum()
    return mindist[:int(n_valid)].sum()


def estep_assign_cuda(x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  x [N, D] f32 and c [K, D] f32, contiguous on one
    CUDA device, K >= 1.  Returns (labels [N] int32, mindist [N] f32) with
    the kernel's arithmetic: min over j of |c_j|^2 - 2 x·c_j (products of
    bf16 hi / lo splits, as the JAX package's ``Precision.HIGH`` route),
    then max(min + |x|^2, 0).  Counts its launches in
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
    _launch(build.load("estep"), x, c, labels, mindist)
    estep_assign_cuda.launches += 1
    return labels, mindist


estep_assign_cuda.launches = 0


def _launch(lib, x, c, labels, mindist) -> None:
    """The C entry point ``estep_assign`` of ``lib`` on checked tensors,
    with its scratch: the centers' bf16 hi / lo [Kp, Dx] and |c|^2 [Kp]
    (K rounded up to 128, D to 8), and an aligned copy of x [N, D rounded
    up to 4] where TMA cannot read x where it lies (D % 4 != 0 or a base
    not 16-byte aligned)."""
    n, d = x.shape
    k = c.shape[0]
    kp, dx, dp = -(-k // 128) * 128, -(-d // 8) * 8, -(-d // 4) * 4
    dev = x.device
    chi = torch.empty(kp, dx, dtype=torch.bfloat16, device=dev)
    clo = torch.empty(kp, dx, dtype=torch.bfloat16, device=dev)
    csq = torch.empty(kp, dtype=torch.float32, device=dev)
    xpad = None
    if d % 4 or x.data_ptr() % 16:
        xpad = torch.empty(n, dp, dtype=torch.float32, device=dev)
    fn = lib.estep_assign
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), c.data_ptr(), n, d, k, kp, dx, dp,
                None if xpad is None else xpad.data_ptr(), chi.data_ptr(),
                clo.data_ptr(), csq.data_ptr(), labels.data_ptr(),
                mindist.data_ptr(), stream)
    build.check(rc, "estep_assign")
