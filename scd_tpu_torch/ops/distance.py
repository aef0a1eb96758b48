"""Pairwise distance + E-step assignment (plain PyTorch).

Port of ``scd_tpu/ops/distance.py``.  Squared euclidean distances use the
matmul expansion ``|x|^2 - 2 x·c^T + |c|^2`` in f32 (TF32 off, see
``core/device.py``), clamped at 0.  These are the plain pieces that
k-means++, the SSKM labelled sums and the fused-EM plain version use; the
fused E+M kernel lives in ``scd_tpu_torch.ops.em``.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
    d = pairwise_sqdist(x, c)
    mindist, labels = torch.min(d, dim=1)
    return labels.to(torch.int32), mindist
