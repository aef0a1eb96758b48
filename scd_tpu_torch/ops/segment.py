"""M-step centroid update as one-hot matmuls (plain PyTorch).

Port of ``scd_tpu/ops/segment.py``.  The one-hot product keeps the sums
deterministic on a CUDA device (``index_add_`` there adds with atomics,
in an order that changes from run to run) and matches the JAX package's
formulation.

Empty-cluster policies of :func:`mstep_update`:
- ``"keep"``  — retain the previous centroid;
- ``"farthest"`` — reseed empty clusters from the points farthest from
  their assigned centroid (the reference's ``_centers_dense`` relocation,
  ``_k_means.pyx:66-78``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def segment_sums(x: torch.Tensor, labels: torch.Tensor, k: int,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums of ``x`` [N, D] grouped by ``labels`` [N].
    Returns (sums [K, D] f32, counts [K] f32)."""
    x = x.float()
    one_hot = torch.nn.functional.one_hot(labels.long(), k).float()  # [N, K]
    if weights is not None:
        one_hot = one_hot * weights.float()[:, None]
    sums = torch.matmul(one_hot.t(), x)  # [K, D]
    counts = one_hot.sum(dim=0)  # [K]
    return sums, counts


def segment_mean(x: torch.Tensor, labels: torch.Tensor, k: int,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster mean; means of empty clusters are 0.  See segment_sums."""
    sums, counts = segment_sums(x, labels, k, weights)
    return sums / counts.clamp_min(1.0)[:, None], counts


def mstep_update(x: torch.Tensor, labels: torch.Tensor, k: int,
                 prev_centers: torch.Tensor,
                 mindist: Optional[torch.Tensor] = None,
                 empty_policy: str = "keep",
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New centroids [K, D] with empty-cluster handling."""
    means, counts = segment_mean(x, labels, k, weights=weights)
    empty = counts < 0.5  # [K]

    if empty_policy == "keep":
        return torch.where(empty[:, None], prev_centers.float(), means)

    if empty_policy == "farthest":
        if mindist is None:
            raise ValueError("empty_policy='farthest' requires mindist")
        # the i-th empty cluster steals the i-th farthest point; zero-weight
        # rows (a sharded caller's padding) never donate
        rank_key = mindist if weights is None else torch.where(
            weights > 0, mindist, torch.full_like(mindist, -float("inf")))
        order = torch.argsort(-rank_key, stable=True)
        empty_rank = torch.cumsum(empty.long(), dim=0) - 1
        donor_idx = order[empty_rank.clamp(0, x.shape[0] - 1)]
        donors = x.index_select(0, donor_idx).float()  # [K, D]
        return torch.where(empty[:, None], donors, means)

    raise ValueError(f"unknown empty_policy {empty_policy!r}")
