"""Fused vocabulary classification: logits -> softmax -> top-k.

Port of ``scd_tpu/ops/topk.py::classify_topk``.  Dispatch by device and
k, decided before any launch:

- a CUDA tensor with k <= 16 and V >= k runs the hand-written kernel
  (``csrc/topk_softmax.cu``, replacing the TPU kernel
  ``scd_tpu/ops/pallas_kernels.py::topk_softmax_pallas``); the [N, V]
  logits never exist in device memory;
- a CUDA tensor with k > 16 takes the route the JAX package takes for k
  beyond its kernel (``_classify_topk_xla``): :func:`classify_topk_plain`,
  chunked f32 ``torch.matmul`` (TF32 off, the policy every entry point
  sets: ``core/device.py``), a stable descending top-k and the
  log-sum-exp, counted in ``classify_topk.matmul_calls``.  This is the
  reference's own dispatch, not a fallback: a failing kernel still raises;
- a CPU tensor runs :func:`classify_topk_plain`, which mirrors
  ``_classify_topk_xla`` and chunks rows to bound memory;
- anything else raises.

:func:`classify_topk_sharded` splits the vocabulary over a mesh's
``model`` axis: each rank runs the same dispatch on its [D, V/s] columns,
the candidates merge on raw logits by ``all_gather`` and the softmax takes
the exact global normaliser.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scd_tpu_torch.ops import build

KERNEL_MAX_K = 16


def classify_topk(feats: torch.Tensor, weights: torch.Tensor, k: int,
                  scale: float = 100.0,
                  apply_softmax: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k names per row.  feats [N, D] (L2-normalized), weights [D, V].

    Returns (values [N, k] f32, indices [N, k] int32) on the inputs'
    device.  ``apply_softmax`` returns ``softmax(scale * feats @ W)``
    values (softmax is monotonic, so the indices are the same); otherwise
    raw scaled logits.  Ties go to the lowest vocabulary index.
    """
    v = weights.shape[1]
    if v < k:
        raise ValueError(f"classify_topk requires V >= k (V={v}, k={k})")
    if feats.is_cuda:
        if k > KERNEL_MAX_K:  # the JAX package's route past its kernel
            classify_topk.matmul_calls += 1
            return classify_topk_plain(feats, weights, k, scale,
                                       apply_softmax)
        m, s, vals, idx = topk_softmax_cuda(feats, weights, k, scale=scale)
        if apply_softmax:
            vals = torch.exp(vals - m[:, None]) / s[:, None]
        return vals, idx
    if feats.device.type != "cpu":
        raise ValueError(f"classify_topk: unsupported device {feats.device}")
    return classify_topk_plain(feats, weights, k, scale, apply_softmax)


classify_topk.matmul_calls = 0


def classify_topk_plain(feats: torch.Tensor, weights: torch.Tensor, k: int,
                        scale: float = 100.0, apply_softmax: bool = True,
                        chunk_rows: int = 4096
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device: rank raw
    logits (a stable descending sort, so ties keep the lowest index, as
    ``jax.lax.top_k`` does), then normalize only the selected values with
    the full row's log-sum-exp.  Rows go in chunks of ``chunk_rows`` to
    bound the [chunk, V] logits."""
    w = weights.float()
    out_v, out_i = [], []
    for lo in range(0, feats.shape[0], chunk_rows):
        logits = scale * torch.matmul(feats[lo:lo + chunk_rows].float(), w)
        vals, idx = torch.sort(logits, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        if apply_softmax:
            m = logits.max(dim=1, keepdim=True).values
            denom = torch.exp(logits - m).sum(dim=1, keepdim=True)
            vals = torch.exp(vals - m) / denom
        out_v.append(vals)
        out_i.append(idx.to(torch.int32))
    if not out_v:
        return (torch.empty(0, k, device=feats.device),
                torch.empty(0, k, dtype=torch.int32, device=feats.device))
    return torch.cat(out_v), torch.cat(out_i)


def topk_softmax_plain(feats: torch.Tensor, weights: torch.Tensor, k: int,
                       scale: float = 100.0, chunk_rows: int = 4096):
    """The kernel's contract in plain PyTorch, on any device: (m [N],
    s [N], vals [N, k], idx [N, k] int32), the row's logit max, its sum of
    exp(logit - m), and the top-k raw scaled logits (a stable descending
    sort: ties keep the lowest index)."""
    w = weights.float()
    parts = []
    for lo in range(0, feats.shape[0], chunk_rows):
        logits = scale * torch.matmul(feats[lo:lo + chunk_rows].float(), w)
        vals, idx = torch.sort(logits, dim=1, descending=True, stable=True)
        m = logits.max(dim=1).values
        parts.append((m, torch.exp(logits - m[:, None]).sum(dim=1),
                      vals[:, :k], idx[:, :k].to(torch.int32)))
    if not parts:
        z = torch.empty(0, device=feats.device)
        return (z, z, torch.empty(0, k, device=feats.device),
                torch.empty(0, k, dtype=torch.int32, device=feats.device))
    return tuple(torch.cat(t) for t in zip(*parts))


def classify_topk_sharded(feats, weights, k: int, mesh, scale: float = 100.0,
                          apply_softmax: bool = True,
                          model_axis: str = "model"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocabulary-sharded top-k (``scd_tpu/ops/topk.py:79-153``): weights
    [D, V] split over the mesh's ``model_axis`` (V must divide by its
    size).  ``feats`` [N, D] and ``weights`` are the same full value on
    every rank; each rank takes its contiguous [D, V/s] columns.

    Per rank: the kernel (k <= 16 on a card; the plain version on the CPU
    and, counted in ``classify_topk.matmul_calls``, past 16 on a card)
    returns the row max ``m``, the sum ``s`` and the raw top-k of its
    slice.  The candidates merge on RAW logits (softmaxed values saturate
    to exact zeros for dominated candidates) by ``all_gather``, the lowest
    global index first on ties, and the softmax values come from the
    exact global normaliser ``M = max m_r``, ``S = sum s_r exp(m_r - M)``.
    Returns (values [N, k] f32, indices [N, k] int32), the same on every
    rank."""
    from scd_tpu_torch.core.multihost import all_gather, put_global

    n_shards = mesh.axis_size(model_axis)
    v = weights.shape[1]
    if v % n_shards:
        raise ValueError(f"V={v} not divisible by {n_shards} shards")
    w_local = put_global(weights, mesh, model_axis, dim=1).float()
    f = torch.as_tensor(feats).to(mesh.device).float().contiguous()
    v_local = w_local.shape[1]
    if v_local < k:
        raise ValueError(f"classify_topk_sharded requires V/shards >= k "
                         f"(V/shards={v_local}, k={k})")
    if f.is_cuda and k <= KERNEL_MAX_K:
        m, s, vals, idx = topk_softmax_cuda(f, w_local, k, scale=scale)
    else:
        if f.is_cuda:
            classify_topk.matmul_calls += 1
        m, s, vals, idx = topk_softmax_plain(f, w_local, k, scale)
    idx = idx + mesh.axis_index(model_axis) * v_local
    if n_shards > 1:
        group = mesh.group(model_axis)
        packed = all_gather(torch.cat([vals, m[:, None], s[:, None]], 1),
                            group=group)
        all_i = torch.cat(all_gather(idx, group=group), 1)
        all_v = torch.cat([p[:, :k] for p in packed], 1)
        ms = torch.stack([p[:, k] for p in packed], 1)
        m = ms.max(dim=1).values
        s = sum(p[:, k + 1] * torch.exp(p[:, k] - m) for p in packed)
        # lowest global index first among equal logits, then by value
        by_idx = torch.argsort(all_i, dim=1, stable=True)
        all_v, all_i = all_v.gather(1, by_idx), all_i.gather(1, by_idx)
        order = torch.argsort(all_v, dim=1, descending=True,
                              stable=True)[:, :k]
        vals, idx = all_v.gather(1, order), all_i.gather(1, order)
    if apply_softmax:
        vals = torch.exp(vals - m[:, None]) / s[:, None]
    return vals, idx


def topk_softmax_cuda(feats: torch.Tensor, weights: torch.Tensor, k: int,
                      scale: float = 100.0):
    """Launch the kernel.  feats [N, D] f32, weights [D, V] f32, both
    contiguous on one CUDA device; 1 <= k <= 16 and V >= k.

    Returns (m [N], s [N], vals [N, k], idx [N, k] int32): the row's
    online logit max and sum of exp(logit - m), and the top-k raw scaled
    logits with their indices.  The kernel takes the product as three bf16
    products of the split operands on the tensor cores; it splits them
    into a scratch buffer allocated here (4 (N + V) D' bytes, D' = D
    rounded up to 32).  Counts its launches in
    ``topk_softmax_cuda.launches``."""
    if not (feats.is_cuda and weights.is_cuda
            and feats.device == weights.device):
        raise ValueError("topk_softmax_cuda takes CUDA tensors on one device")
    if feats.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"topk_softmax_cuda takes f32, got {feats.dtype} / "
                        f"{weights.dtype}")
    if feats.dim() != 2 or weights.dim() != 2 or \
            feats.shape[1] != weights.shape[0]:
        raise ValueError(f"shapes {tuple(feats.shape)} @ "
                         f"{tuple(weights.shape)} do not chain")
    if not (feats.is_contiguous() and weights.is_contiguous()):
        raise ValueError("topk_softmax_cuda takes contiguous tensors")
    n, d = feats.shape
    v = weights.shape[1]
    if not 1 <= k <= KERNEL_MAX_K or v < k:
        raise ValueError(f"topk_softmax_cuda needs 1 <= k <= {KERNEL_MAX_K} "
                         f"and V >= k (k={k}, V={v})")
    lib = build.load("topk_softmax")
    fn = lib.topk_softmax_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    work_bytes = lib.topk_softmax_work_bytes
    work_bytes.restype = ctypes.c_longlong
    work_bytes.argtypes = [ctypes.c_int] * 3
    dev = feats.device
    work = torch.empty(work_bytes(n, d, v), dtype=torch.uint8, device=dev)
    m = torch.empty(n, dtype=torch.float32, device=dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    vals = torch.empty(n, k, dtype=torch.float32, device=dev)
    idx = torch.empty(n, k, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(feats.data_ptr(), weights.data_ptr(), n, d, v, k,
                float(scale), m.data_ptr(), s.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), work.data_ptr(), stream)
    build.check(rc, "topk_softmax")
    topk_softmax_cuda.launches += 1
    return m, s, vals, idx


topk_softmax_cuda.launches = 0
