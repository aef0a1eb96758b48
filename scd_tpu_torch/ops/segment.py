"""M-step centroid sums as a one-hot matmul (plain PyTorch).

Port of ``scd_tpu/ops/segment.py::segment_sums``.  The one-hot product
keeps the sums deterministic on a CUDA device (``index_add_`` there adds
with atomics, in an order that changes from run to run) and matches the
JAX package's formulation.
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
