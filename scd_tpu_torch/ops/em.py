"""One k-means EM iteration with a single dispatch point.

Port of ``scd_tpu/ops/em.py::em_iteration``.  Dispatch by device:

- a CUDA tensor runs the hand-written fused kernel (``csrc/fused_em.cu``,
  replacing the TPU kernel ``scd_tpu/ops/pallas_kernels.py::
  fused_em_step_pallas``): one pass over x gives labels, row-masked sums,
  counts and inertia, deterministically;
- a CPU tensor runs :func:`em_iteration_plain`, ``estep_assign_plain`` +
  ``segment_sums`` as in ``scd_tpu/ops/em.py:61-67``.

There is no fallback from the kernel to the plain version.  The sharded
variant comes with the multi-device slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from scd_tpu_torch.ops import build

EMResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def em_iteration(x: torch.Tensor, centers: torch.Tensor, k: int,
                 row_w: Optional[torch.Tensor] = None,
                 fused: Optional[bool] = None,
                 estep_passes: int = 3, x_bf16: bool = False) -> EMResult:
    """(labels [N] int32, sums [K, D], counts [K], inertia 0-d) for one EM
    iteration over ``x`` [N, D] given ``centers`` [<=K, D].

    ``row_w`` [N] (0/1) drops rows from sums/counts/inertia.  ``centers``
    with fewer than ``k`` rows are padded with far sentinels that never win
    the argmin and get zero sums and counts, so every path returns
    [k]-shaped results.  ``fused=None`` picks the kernel on a CUDA device
    and the plain version on the CPU; ``fused=False`` on a CUDA device
    raises.  ``x_bf16`` reads x as bf16 (the kernel's bandwidth mode; the
    plain version rounds x to bf16 the same way); x may also arrive as
    bf16 already.  ``estep_passes`` selects TPU bf16 splits of the cross
    term and has no effect here: both paths compute it in f32.  As in the
    JAX package, x_bf16 only applies on the fused path.
    """
    del estep_passes
    if k != centers.shape[0]:
        if k < centers.shape[0]:
            raise ValueError(f"k={k} < centers rows {centers.shape[0]}")
        pad = torch.full((k - centers.shape[0], centers.shape[1]), 1e15,
                         dtype=torch.float32, device=centers.device)
        centers = torch.cat([centers.float(), pad])
    if x.is_cuda:
        if fused is False:
            raise ValueError("em_iteration(fused=False) on a CUDA tensor: "
                             "the plain EM version runs on the CPU only")
        if x_bf16 and x.dtype != torch.bfloat16:
            x = x.to(torch.bfloat16)
        return fused_em_step_cuda(x, centers, row_w)
    if x.device.type != "cpu":
        raise ValueError(f"em_iteration: unsupported device {x.device}")
    if fused and x_bf16:
        x = x.to(torch.bfloat16)
    return em_iteration_plain(x, centers, k, row_w)


def em_iteration_plain(x: torch.Tensor, centers: torch.Tensor, k: int,
                       row_w: Optional[torch.Tensor] = None) -> EMResult:
    """The plain PyTorch version (``estep_assign_plain`` +
    ``segment_sums``), on any device; x in f32 or bf16, computed in f32."""
    from scd_tpu_torch.ops.distance import estep_assign_plain
    from scd_tpu_torch.ops.segment import segment_sums

    x = x.float()
    labels, mindist = estep_assign_plain(x, centers)
    inertia = (mindist if row_w is None else mindist * row_w.float()).sum()
    sums, counts = segment_sums(x, labels, k, weights=row_w)
    return labels, sums, counts, inertia


def fused_em_step_cuda(x: torch.Tensor, centers: torch.Tensor,
                       row_w: Optional[torch.Tensor] = None) -> EMResult:
    """Launch the fused kernel.  x [N, D] f32 or bf16, centers [K, D] f32,
    row_w [N] f32 or None, all contiguous on one CUDA device.  Counts its
    launches in ``fused_em_step_cuda.launches``."""
    dev = x.device
    if not (x.is_cuda and centers.device == dev
            and (row_w is None or row_w.device == dev)):
        raise ValueError("fused_em_step_cuda takes CUDA tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if centers.dtype != torch.float32 or (
            row_w is not None and row_w.dtype != torch.float32):
        raise TypeError("centers and row_w must be f32")
    if x.dim() != 2 or centers.dim() != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, centers "
                         f"{tuple(centers.shape)} do not match")
    if row_w is not None and tuple(row_w.shape) != (x.shape[0],):
        raise ValueError(f"row_w must be [{x.shape[0]}], got "
                         f"{tuple(row_w.shape)}")
    if not (x.is_contiguous() and centers.is_contiguous()
            and (row_w is None or row_w.is_contiguous())):
        raise ValueError("fused_em_step_cuda takes contiguous tensors")
    n, d = x.shape
    k = centers.shape[0]
    if k < 1 or d < 1:
        raise ValueError(f"empty centers {tuple(centers.shape)}")
    lib = build.load("fused_em")
    fn = lib.fused_em_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 9)
    # persistent grid, ~2 blocks per SM; the slab count fixes the order of
    # the cross-block sums, so it depends only on N and the card
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // 128), 2 * sms))
    f32 = dict(dtype=torch.float32, device=dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(k, d, **f32)
    counts = torch.empty(k, **f32)
    inertia = torch.empty((), **f32)
    csq = torch.empty(k, **f32)
    slab_sums = torch.empty(grid, k, d, **f32)
    slab_counts = torch.empty(grid, k, **f32)
    slab_inertia = torch.empty(grid, **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                centers.data_ptr(),
                None if row_w is None else row_w.data_ptr(),
                n, d, k, grid, labels.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), inertia.data_ptr(), csq.data_ptr(),
                slab_sums.data_ptr(), slab_counts.data_ptr(),
                slab_inertia.data_ptr(), stream)
    build.check(rc, "fused_em_step")
    fused_em_step_cuda.launches += 1
    return labels, sums, counts, inertia


fused_em_step_cuda.launches = 0
