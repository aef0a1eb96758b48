"""k-means++ seeding on the features' device.

Port of ``scd_tpu/ops/kpp.py::kmeans_plus_plus`` (reference
``sskm_constrained.py:28-44``): the running min-distance ``d2`` is kept
incrementally and each draw is an inverse-CDF search, the reference's
``cum_prob >= r``.  Draws come from a ``torch.Generator``; they are not the
JAX package's ``jax.random`` bits, so parity tests hand both packages the
same initial centers instead (ROADMAP records the choice).

``pre_centers`` pins the first P centers (the semi-supervised variant seeds
them from labelled class means, ``sskm_constrained.py:108``).
:func:`kmeans_plus_plus_local_trials` is the greedy variant constrained
clustering seeds with.  The padding arguments of the JAX package
(``n_valid``) belong to the multi-device slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scd_tpu_torch.ops.distance import pairwise_sqdist


def auto_local_trials(k: int) -> int:
    """The vendored package's greedy-trial count
    (``k_means_constrained_.py:93-96``)."""
    return 2 + int(np.log(k))


def _first_centers(x: torch.Tensor, k: int, generator: torch.Generator,
                   pre_centers: Optional[torch.Tensor]):
    """(centers [k, D] with the first ``start`` rows set, running min
    distance d2 [N], start): the pins, or one uniform draw."""
    n, d = x.shape
    dev = x.device
    if pre_centers is not None and pre_centers.shape[0] == 0:
        pre_centers = None  # empty pin set == unsupervised seeding
    centers = torch.zeros(k, d, dtype=torch.float32, device=dev)
    if pre_centers is not None:
        p = pre_centers.shape[0]
        centers[:p] = pre_centers.float()
        return centers, pairwise_sqdist(x, pre_centers).min(dim=1).values, p
    first = torch.randint(0, n, (1,), generator=generator, device=dev)
    c0 = x.index_select(0, first)
    centers[0] = c0[0]
    return centers, ((x - c0) ** 2).sum(dim=1), 1


def kmeans_plus_plus(x: torch.Tensor, k: int, generator: torch.Generator,
                     pre_centers: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Sample ``k`` centers [k, D] f32 from ``x`` [N, D].  Every step stays
    on the device (no host round-trip per draw)."""
    x = x.float()
    dev = x.device
    centers, d2, start = _first_centers(x, k, generator, pre_centers)
    for i in range(start, k):
        prob = d2 / d2.sum().clamp_min(1e-30)
        cum = torch.cumsum(prob, dim=0)
        r = torch.rand((1,), generator=generator, device=dev)
        idx = torch.argmax((cum >= r).to(torch.uint8))  # first cum_prob >= r
        new_c = x.index_select(0, idx.view(1))
        centers[i] = new_c[0]
        d2 = torch.minimum(d2, ((x - new_c) ** 2).sum(dim=1))
    return centers


def kmeans_plus_plus_local_trials(x: torch.Tensor, k: int,
                                  generator: torch.Generator,
                                  n_local_trials: Optional[int] = None,
                                  pre_centers: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """k-means++ with greedy local trials (the vendored package's
    ``_k_init``, ``k_means_constrained_.py:89-144``): each step draws
    ``n_local_trials`` candidates D^2-proportionally (default
    ``2 + int(log(k))``) and keeps the one whose potential is least.  The
    T trials are scored as one [N, T] distance block; ties go to the
    first trial."""
    n = x.shape[0]
    x = x.float()
    dev = x.device
    t = n_local_trials or auto_local_trials(k)
    centers, d2, start = _first_centers(x, k, generator, pre_centers)
    for i in range(start, k):
        pot = d2.sum().clamp_min(1e-30)
        # searchsorted on the unnormalized cumsum (the reference's
        # rand * current_pot); when the remaining mass is ~0 the search
        # lands past the end, so clip to the last row
        r = torch.rand((t,), generator=generator, device=dev) * pot
        cand = torch.searchsorted(torch.cumsum(d2, dim=0), r).clamp_(0, n - 1)
        new_d2 = torch.minimum(d2[:, None],
                               pairwise_sqdist(x, x.index_select(0, cand)))
        best = torch.argmin(new_d2.sum(dim=0))
        centers[i] = x[cand[best]]
        d2 = new_d2[:, best]
    return centers
