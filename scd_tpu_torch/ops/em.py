"""One k-means EM iteration with a single dispatch point.

Port of ``scd_tpu/ops/em.py::em_iteration``.  Dispatch by device:

- a CUDA tensor runs the hand-written kernels of ``csrc/fused_em.cu``
  (replacing the TPU kernel ``scd_tpu/ops/pallas_kernels.py::
  fused_em_step_pallas``): split-bf16 products on the tensor cores give
  labels, row-masked sums, counts and inertia, deterministically, cut as
  :func:`em_plan` says;
- a CPU tensor runs :func:`em_iteration_plain`, ``estep_assign_plain`` +
  ``segment_sums`` as in ``scd_tpu/ops/em.py:61-67``.

There is no fallback from the kernel to the plain version.
:func:`em_iteration_sharded` runs the same per rank on its row shard and
merges the partial sums, counts and inertia with one ``all_reduce``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

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
    bf16 already.  ``estep_passes`` has no effect here: the kernel takes
    the TPU kernel's default split, three bf16 passes of the cross term for
    f32 x and two for bf16 x, and the plain version computes it in f32.
    As in the JAX package, x_bf16 only applies on the fused path.
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


def em_iteration_sharded(x: torch.Tensor, centers: torch.Tensor,
                         row_w: Optional[torch.Tensor], mesh,
                         estep_passes: int = 3, x_bf16: bool = False,
                         fused: Optional[bool] = None,
                         live: Optional[int] = None) -> EMResult:
    """One EM iteration over a mesh (``scd_tpu/ops/em.py:70-128``).

    ``x`` [n, D] is THIS rank's row shard (padded rows weighted 0 in
    ``row_w`` [n], or ``row_w`` None), ``centers`` [K, D] the same on every
    rank.  Each rank runs :func:`em_iteration` (the fused kernel on a card,
    the plain version on the CPU) on its rows; the [K, D] sums, [K] counts
    and the inertia go as one packed f32 [K*D + K + 1] vector through ONE
    ``all_reduce`` over the data axis, so every rank holds the same merged
    values.  Labels stay local ([n], this rank's rows).  ``live``: the
    centers at or past it are far sentinels no row takes (estimate_k's
    dynamic K), so their sums and counts are zero on every rank and only
    the first ``live`` go through the ``all_reduce``."""
    from scd_tpu_torch.core.multihost import all_reduce

    k, d = centers.shape
    labels, sums, counts, inertia = em_iteration(
        x, centers, k, row_w=row_w, fused=fused, estep_passes=estep_passes,
        x_bf16=x_bf16)
    if mesh is None:
        return labels, sums, counts, inertia
    m = k if live is None else live
    packed = all_reduce(torch.cat([sums[:m].reshape(-1), counts[:m],
                                   inertia.reshape(1)]),
                        group=mesh.data_group)
    sums_m, counts_m = packed[:m * d].view(m, d), packed[m * d:m * d + m]
    if m < k:
        sums_m = torch.cat([sums_m, sums[m:]])
        counts_m = torch.cat([counts_m, counts[m:]])
    return labels, sums_m, counts_m, packed[-1]


class EMPlan(NamedTuple):
    """How ``csrc/fused_em.cu`` cuts one EM iteration, and its scratch.

    ``kp``: centers padded to whole center tiles of 128; ``dx``: the bf16
    row length the kernels read (``d``, or ``d`` rounded up to 8 when x is
    rewritten); ``rewrite``: x is written once to bf16 [N, dx] (hi, and lo
    for f32 x) because TMA cannot read it where it lies; ``eblocks``:
    persistent E-step blocks over row tiles of 128; ``runs`` x
    ``run_stages``: the M-step's runs of 64-row stages; ``dchunks``: its
    128-column chunks; ``offsets``: byte offset of each scratch buffer in
    one allocation of ``work_bytes`` (each 1024-aligned)."""
    kp: int
    dx: int
    rewrite: bool
    eblocks: int
    runs: int
    run_stages: int
    dchunks: int
    offsets: Dict[str, int]
    work_bytes: int


@functools.lru_cache(maxsize=64)
def em_plan(n: int, d: int, k: int, x_bf16: bool, sms: int,
            x_aligned: bool = True) -> EMPlan:
    """The plan of one ``fused_em_step`` call at these shapes on a card with
    ``sms`` SMs.  It depends only on the shapes and the card, so the order
    of every cross-block sum does too.  The M-step units (runs x center
    groups x column chunks) are sized to about one per SM."""
    kp = -(-k // 128) * 128
    rewrite = (not x_bf16) or d % 8 != 0 or not x_aligned
    dx = -(-d // 8) * 8 if rewrite else d
    dchunks = -(-dx // 128)
    eblocks = min(-(-n // 128), sms)
    stages = -(-n // 64)
    runs = min(stages, max(1, -(-sms // ((kp // 128) * dchunks))))
    run_stages = -(-stages // runs) if runs else 0
    runs = -(-stages // run_stages) if runs else 0
    sizes = {"chi": kp * dx * 2, "clo": kp * dx * 2, "csq": kp * 4,
             "xhi": n * dx * 2 if rewrite else 0,
             "xlo": n * dx * 2 if not x_bf16 else 0,
             "lw": stages * 64 * 8,
             "part_sums": runs * kp * dchunks * 128 * 4,
             "part_counts": runs * kp * 4, "ine_part": eblocks * 4}
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += -(-size // 1024) * 1024
    return EMPlan(kp, dx, rewrite, eblocks, runs, run_stages, dchunks,
                  offsets, max(at, 1024))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_EM_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p] + [ctypes.c_int] * 9
                + [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p])


def fused_em_launch(x: torch.Tensor, centers: torch.Tensor,
                    row_w: Optional[torch.Tensor] = None, phases: int = 15,
                    work: Optional[torch.Tensor] = None):
    """Launch the kernels of one iteration (``phases``: 1 split, 2 E-step,
    4 M-step, 8 finalize) and return (labels, sums, counts, inertia, work).
    ``fused_em_step_cuda`` runs all four; a part alone is for timing, with
    the ``work`` buffer of an earlier call.  Counts nothing."""
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
    x_bf16 = x.dtype == torch.bfloat16
    plan = em_plan(n, d, k, x_bf16, _sm_count(dev), x.data_ptr() % 16 == 0)
    fn = build.load("fused_em").fused_em_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _EM_ARGTYPES
    if work is None or work.numel() < plan.work_bytes:
        work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(k, d, **f32)
    counts = torch.empty(k, **f32)
    inertia = torch.empty((), **f32)
    at = {name: work.data_ptr() + off for name, off in plan.offsets.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), int(x_bf16), centers.data_ptr(),
                None if row_w is None else row_w.data_ptr(), n, d, k,
                plan.kp, plan.dx, plan.eblocks, plan.runs, plan.run_stages,
                plan.dchunks, labels.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), inertia.data_ptr(), at["chi"], at["clo"],
                at["csq"], at["xhi"] if plan.rewrite else None,
                None if x_bf16 else at["xlo"], at["lw"], at["part_sums"],
                at["part_counts"], at["ine_part"], phases, stream)
    build.check(rc, "fused_em_step")
    return labels, sums, counts, inertia, work


def fused_em_step_cuda(x: torch.Tensor, centers: torch.Tensor,
                       row_w: Optional[torch.Tensor] = None) -> EMResult:
    """Launch the fused kernels (split, E-step, M-step, finalize).  x
    [N, D] f32 or bf16, centers [K, D] f32, row_w [N] f32 or None, all
    contiguous on one CUDA device.  Counts its launches in
    ``fused_em_step_cuda.launches``."""
    labels, sums, counts, inertia, _ = fused_em_launch(x, centers, row_w)
    fused_em_step_cuda.launches += 1
    return labels, sums, counts, inertia


fused_em_step_cuda.launches = 0
