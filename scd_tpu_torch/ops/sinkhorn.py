"""Size-constrained assignment via entropic OT + integral repair, on the
cost's device.

Port of ``scd_tpu/ops/sinkhorn.py`` (the JAX package's alternative to the
reference's per-iteration host min-cost flow, ``sskm_constrained.py:67,
116``):

1. **Sinkhorn scaling with column box constraints.**  Minimize <C, P> +
   eps*H(P) s.t. row sums = 1 and column sums in [size_min, size_max], by
   alternating log-domain projections: the row step is exact, the column
   step rescales each column into the box.
2. **Integral rounding + repair.**  labels = argmin_j (C_ij - g_j), then
   repair passes: overfull clusters evict their cheapest-to-move members
   toward clusters with room, underfull clusters steal the cheapest-to-move
   members of clusters with spare capacity, each ranked inside its
   cluster by one stable sort.  The loop exits as soon as the counts are
   feasible.

Every step runs on the cost's device.  The host reads one scalar per dual
iteration (the JAX ``while_loop``'s exit test, checked after every
iteration: the stopping iteration decides which near-tie labels the repair
starts from) and one flag per repair pass.  Returns a feasibility flag;
the ConSSKM caller goes on to the exact min-cost-flow track
(``ops/native.py``) when it is False.  The padded rows of sharded runs
(``row_mask``, sentinel label k) belong to the multi-device slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class ConstrainedAssignment(NamedTuple):
    labels: torch.Tensor  # [N] int32
    feasible: bool
    col_duals: torch.Tensor  # [K] f32 (g)


def _sinkhorn_duals(cost: torch.Tensor, size_min, size_max, eps: float,
                    iters: int, tol: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Log-domain scaling; returns (f [N], g [K]) duals and the number of
    iterations run.  Stops after ``iters`` iterations or once the
    column-dual update falls below ``tol`` (the cost is unit-std
    normalized by the caller), tested after every iteration in f32 as the
    JAX loop tests it."""
    n, k = cost.shape
    dev = cost.device
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    g = torch.zeros(k, dtype=torch.float32, device=dev)
    log_lo = float(np.log(np.maximum(np.float32(size_min), np.float32(1e-9))))
    log_hi = float(np.log(np.maximum(np.float32(size_max), np.float32(1e-9))))
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    tol32 = float(np.float32(tol))
    i, delta = 0, float("inf")
    while i < iters and delta >= tol32:
        f = -eps_t * torch.logsumexp((g[None, :] - cost) / eps_t, dim=1)
        log_col = torch.logsumexp((f[:, None] + g[None, :] - cost) / eps_t,
                                  dim=0)  # log column sums
        target = log_col.clamp(log_lo, log_hi)
        g_new = g + eps_t * (target - log_col)
        delta = float((g_new - g).abs().max())
        g = g_new
        i += 1
    return f, g, i


def _counts(labels: torch.Tensor, k: int) -> torch.Tensor:
    # jnp.bincount(length=k) drops values >= k; torch's minlength grows
    return torch.bincount(labels, minlength=k)[:k]


def _within_cluster_rank(labels: torch.Tensor, key: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Rank of each point inside its cluster when ordered by ``key`` asc.
    Non-finite keys rank last within their cluster.  The composite key is
    f32 and the sort stable, as in the JAX package: an f64 key or an
    unstable sort orders near-equal keys otherwise."""
    n = labels.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=key.device)
    finite = torch.isfinite(key)
    any_f = finite.any()
    fmin = torch.where(finite, key, inf).min()
    fmax = torch.where(finite, key, -inf).max()
    kmin = torch.where(any_f, fmin, torch.zeros_like(fmin))
    kptp = (torch.where(any_f, fmax, torch.ones_like(fmax)) - kmin
            ).clamp_min(1e-12)
    key_n = torch.where(finite, (key - kmin) / kptp,
                        torch.full_like(key, 1.5))
    composite = labels.float() * 2.0 + key_n
    order = torch.argsort(composite, stable=True)
    pos = torch.empty(n, dtype=torch.int64, device=labels.device)
    pos[order] = torch.arange(n, device=labels.device)
    counts = _counts(labels, k)
    start = torch.cumsum(counts, dim=0) - counts
    return pos - start[labels]


def _evict_pass(cost, labels, g, size_min, size_max, k):
    """Move the cheapest members of overfull clusters to clusters with
    room.  ``labels`` int64."""
    counts = _counts(labels, k)
    excess = (counts - size_max).clamp_min(0)
    red = cost - g[None, :]
    cur = red.gather(1, labels[:, None])[:, 0]
    has_room = (counts < size_max)[None, :]
    not_self = torch.nn.functional.one_hot(labels, k) == 0
    masked = torch.where(has_room & not_self, red,
                         torch.full_like(red, float("inf")))
    alt, alt_j = masked.min(dim=1)
    regret = torch.where(torch.isfinite(alt), alt - cur,
                         torch.full_like(alt, float("inf")))
    rank = _within_cluster_rank(labels, regret, k)
    evict = (rank < excess[labels]) & torch.isfinite(regret)
    return torch.where(evict, alt_j, labels)


def _steal_pass(cost, labels, g, size_min, size_max, k):
    """Move the cheapest outside members into underfull clusters.
    ``labels`` int64."""
    counts = _counts(labels, k)
    deficit = (size_min - counts).clamp_min(0)
    red = cost - g[None, :]
    cur = red.gather(1, labels[:, None])[:, 0]
    # sources must keep >= size_min after losing a member
    src_spare = (counts > size_min)[labels]
    masked = torch.where((deficit > 0)[None, :], red,
                         torch.full_like(red, float("inf")))
    best, dest = masked.min(dim=1)
    move_cost = best - cur
    candidate = src_spare & torch.isfinite(move_cost)
    move_key = torch.where(candidate, move_cost,
                           torch.full_like(move_cost, float("inf")))
    rank = _within_cluster_rank(dest, move_key, k)
    move = candidate & (rank < deficit[dest])
    return torch.where(move, dest, labels)


def _feasible(labels: torch.Tensor, k: int, size_min, size_max) -> bool:
    counts = _counts(labels, k)
    return bool(((counts >= size_min) & (counts <= size_max)).all())


def sinkhorn_constrained_assign(cost: torch.Tensor, k: int,
                                size_min: int, size_max: int,
                                eps: float = 0.05, iters: int = 200,
                                repair_passes: int = 8
                                ) -> ConstrainedAssignment:
    """Size-constrained assignment for the cost matrix [N, K] on its
    device.  ``cost`` is on the scale of unit-norm distances (the ConSSKM
    caller passes sqrt of squared distances, as the reference's MCF costs
    are); ``eps`` is relative to the cost's (population) std."""
    cost = cost.float()
    c_std = cost.std(correction=0).clamp_min(1e-6)
    cost_n = cost / c_std  # eps is hence relative to the cost std
    _f, g, n_dual = _sinkhorn_duals(cost_n, size_min, size_max, eps, iters)
    labels = torch.argmin(cost_n - g[None, :], dim=1)
    # the repair exits once the counts are feasible: excess and deficit
    # are then zero, so further passes would change nothing
    feasible = _feasible(labels, k, size_min, size_max)
    it = 0
    while it < repair_passes and not feasible:
        labels = _evict_pass(cost_n, labels, g, size_min, size_max, k)
        labels = _steal_pass(cost_n, labels, g, size_min, size_max, k)
        feasible = _feasible(labels, k, size_min, size_max)
        it += 1
    sinkhorn_constrained_assign.calls += 1
    sinkhorn_constrained_assign.dual_iterations += n_dual
    sinkhorn_constrained_assign.repair_passes += it
    return ConstrainedAssignment(labels=labels.to(torch.int32),
                                 feasible=feasible, col_duals=g * c_std)


# calls, dual iterations and repair passes run, summed over calls
sinkhorn_constrained_assign.calls = 0
sinkhorn_constrained_assign.dual_iterations = 0
sinkhorn_constrained_assign.repair_passes = 0
