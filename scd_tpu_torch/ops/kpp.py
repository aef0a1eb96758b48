"""k-means++ seeding on the features' device.

Port of ``scd_tpu/ops/kpp.py::kmeans_plus_plus`` (reference
``sskm_constrained.py:28-44``): the running min-distance ``d2`` is kept
incrementally and each draw is an inverse-CDF search, the reference's
``cum_prob >= r``.  Draws come from a ``torch.Generator``; they are not the
JAX package's ``jax.random`` bits, so parity tests hand both packages the
same initial centers instead (ROADMAP records the choice).

``pre_centers`` pins the first P centers (the semi-supervised variant seeds
them from labelled class means, ``sskm_constrained.py:108``).  The greedy
local-trials variant comes with constrained clustering, its only caller.
"""

from __future__ import annotations

from typing import Optional

import torch

from scd_tpu_torch.ops.distance import pairwise_sqdist


def kmeans_plus_plus(x: torch.Tensor, k: int, generator: torch.Generator,
                     pre_centers: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Sample ``k`` centers [k, D] f32 from ``x`` [N, D].  Every step stays
    on the device (no host round-trip per draw)."""
    n, d = x.shape
    x = x.float()
    dev = x.device
    if pre_centers is not None and pre_centers.shape[0] == 0:
        pre_centers = None  # empty pin set == unsupervised seeding
    centers = torch.zeros(k, d, dtype=torch.float32, device=dev)
    if pre_centers is not None:
        p = pre_centers.shape[0]
        centers[:p] = pre_centers.float()
        d2 = pairwise_sqdist(x, pre_centers).min(dim=1).values
        start = p
    else:
        first = torch.randint(0, n, (1,), generator=generator, device=dev)
        c0 = x.index_select(0, first)
        centers[0] = c0[0]
        d2 = ((x - c0) ** 2).sum(dim=1)
        start = 1

    for i in range(start, k):
        prob = d2 / d2.sum().clamp_min(1e-30)
        cum = torch.cumsum(prob, dim=0)
        r = torch.rand((1,), generator=generator, device=dev)
        idx = torch.argmax((cum >= r).to(torch.uint8))  # first cum_prob >= r
        new_c = x.index_select(0, idx.view(1))
        centers[i] = new_c[0]
        d2 = torch.minimum(d2, ((x - new_c) ** 2).sum(dim=1))
    return centers
