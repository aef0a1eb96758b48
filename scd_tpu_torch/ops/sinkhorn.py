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
(``ops/native.py``) when it is False.

``row_mask`` [N] bool marks the real rows of a padded (sharded) input:
pad rows carry no transport mass, take the sentinel label ``k`` (outside
every count) and never move in repair.  Over a ``mesh``
(``core/mesh.py``) the cost is THIS RANK's rows (the ranks' padded shares
are equally wide: ``core.multihost.rows_from_process_local``) and what is
global crosses the ``data`` axis: the cost's std, each dual iteration's
column log-sum-exp (a max ``all_reduce`` then a sum ``all_reduce`` of the
rescaled exponentials, the exact merge), the cluster counts (a sum
``all_reduce``), and the within-cluster rank (every rank gathers every
row's (label, key), ranks them globally and keeps its own rows: ~1 MB at
130k rows).  The duals, the exit test and the feasibility flag are then
the same bits on every rank.  A mesh of one rank runs exactly the
single-process operations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class ConstrainedAssignment(NamedTuple):
    labels: torch.Tensor  # [N] int32 (k on pad rows)
    feasible: bool
    col_duals: torch.Tensor  # [K] f32 (g)


class _Ranks:
    """Reductions over the rows of every rank on the mesh's ``data`` axis;
    with no mesh (or one rank) each is the single-process operation."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.n = 1 if mesh is None else mesh.n_data

    def _reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        if self.n == 1:
            return t
        from scd_tpu_torch.core.multihost import all_reduce

        return all_reduce(t, op, group=self.mesh.data_group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, "sum")

    def std(self, cost: torch.Tensor) -> torch.Tensor:
        """Population std of every rank's cost entries (pads included, as
        the JAX function's ``jnp.std`` of the staged array)."""
        if self.n == 1:
            return cost.std(correction=0)
        n = torch.tensor(float(cost.numel()), dtype=torch.float64,
                         device=cost.device)
        c64 = cost.double()
        tot = self.sum(torch.stack([n, c64.sum()]))
        mean = tot[1] / tot[0]
        var = self.sum(((c64 - mean) ** 2).sum()) / tot[0]
        return var.sqrt().float()

    def logsumexp_rows(self, z: torch.Tensor) -> torch.Tensor:
        """``logsumexp`` over dim 0 of every rank's rows [K]: the columns'
        max all-reduced, then the sum of the shifted exponentials."""
        if self.n == 1:
            return torch.logsumexp(z, dim=0)
        m = self._reduce(z.amax(dim=0), "max")
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        return torch.log(self.sum(torch.exp(z - m).sum(dim=0))) + m

    def rank_in_cluster(self, labels: torch.Tensor, key: torch.Tensor,
                        k: int) -> torch.Tensor:
        """:func:`_within_cluster_rank` over every rank's rows, for this
        rank's rows: one ``all_gather`` of (label, key) packed f32 (labels
        up to k are exact in f32)."""
        if self.n == 1:
            return _within_cluster_rank(labels, key, k)
        from scd_tpu_torch.core.multihost import all_gather

        packed = torch.stack([labels.float(), key.float()], dim=1)
        rows = torch.cat(all_gather(packed, group=self.mesh.data_group))
        ranks = _within_cluster_rank(rows[:, 0].long(), rows[:, 1], k)
        lo = self.mesh.data_index * labels.shape[0]
        return ranks[lo:lo + labels.shape[0]]

    def counts(self, labels: torch.Tensor, k: int) -> torch.Tensor:
        return self.sum(_counts(labels, k))


def _sinkhorn_duals(cost: torch.Tensor, size_min, size_max, eps: float,
                    iters: int, tol: float = 1e-6,
                    row_mask: Optional[torch.Tensor] = None,
                    ranks: Optional[_Ranks] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Log-domain scaling; returns (f [N], g [K]) duals and the number of
    iterations run.  Stops after ``iters`` iterations or once the
    column-dual update falls below ``tol`` (the cost is unit-std
    normalized by the caller), tested after every iteration in f32 as the
    JAX loop tests it.  Rows where ``row_mask`` is False get f = -inf:
    zero mass in every column."""
    ranks = ranks or _Ranks()
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
        if row_mask is not None:
            f = torch.where(row_mask, f, torch.full_like(f, float("-inf")))
        log_col = ranks.logsumexp_rows(
            (f[:, None] + g[None, :] - cost) / eps_t)  # log column sums
        target = log_col.clamp(log_lo, log_hi)
        g_new = g + eps_t * (target - log_col)
        delta = float((g_new - g).abs().max())
        g = g_new
        i += 1
    return f, g, i


def _counts(labels: torch.Tensor, k: int) -> torch.Tensor:
    # jnp.bincount(length=k) drops values >= k (the pads' sentinel);
    # torch's minlength grows
    return torch.bincount(labels, minlength=k)[:k]


def _within_cluster_rank(labels: torch.Tensor, key: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Rank of each point inside its cluster when ordered by ``key`` asc.
    Non-finite keys rank last within their cluster.  The composite key is
    f32 and the sort stable, as in the JAX package: an f64 key or an
    unstable sort orders near-equal keys otherwise.  A pad row (label k)
    sorts after every cluster; its rank is not used."""
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
    return pos - start[labels.clamp_max(k - 1)]


def _evict_pass(cost, labels, g, size_min, size_max, k,
                ranks: Optional[_Ranks] = None):
    """Move the cheapest members of overfull clusters to clusters with
    room.  ``labels`` int64; pad rows (label k) never move."""
    ranks = ranks or _Ranks()
    real = labels < k
    labels_ix = labels.clamp_max(k - 1)
    counts = ranks.counts(labels, k)
    excess = (counts - size_max).clamp_min(0)
    red = cost - g[None, :]
    cur = red.gather(1, labels_ix[:, None])[:, 0]
    has_room = (counts < size_max)[None, :]
    not_self = labels[:, None] != torch.arange(k, device=labels.device)
    masked = torch.where(has_room & not_self, red,
                         torch.full_like(red, float("inf")))
    alt, alt_j = masked.min(dim=1)
    regret = torch.where(torch.isfinite(alt) & real, alt - cur,
                         torch.full_like(alt, float("inf")))
    rank = ranks.rank_in_cluster(labels, regret, k)
    evict = (rank < excess[labels_ix]) & torch.isfinite(regret) & real
    return torch.where(evict, alt_j, labels)


def _steal_pass(cost, labels, g, size_min, size_max, k,
                ranks: Optional[_Ranks] = None):
    """Move the cheapest outside members into underfull clusters.
    ``labels`` int64; pad rows (label k) are never candidates."""
    ranks = ranks or _Ranks()
    real = labels < k
    labels_ix = labels.clamp_max(k - 1)
    counts = ranks.counts(labels, k)
    deficit = (size_min - counts).clamp_min(0)
    red = cost - g[None, :]
    cur = red.gather(1, labels_ix[:, None])[:, 0]
    # sources must keep >= size_min after losing a member
    src_spare = (counts > size_min)[labels_ix]
    masked = torch.where((deficit > 0)[None, :], red,
                         torch.full_like(red, float("inf")))
    best, dest = masked.min(dim=1)
    move_cost = best - cur
    candidate = src_spare & torch.isfinite(move_cost) & real
    move_key = torch.where(candidate, move_cost,
                           torch.full_like(move_cost, float("inf")))
    rank = ranks.rank_in_cluster(dest, move_key, k)
    move = candidate & (rank < deficit[dest])
    return torch.where(move, dest, labels)


def _feasible(labels: torch.Tensor, k: int, size_min, size_max,
              ranks: _Ranks) -> bool:
    counts = ranks.counts(labels, k)
    return bool(((counts >= size_min) & (counts <= size_max)).all())


def sinkhorn_constrained_assign(cost: torch.Tensor, k: int,
                                size_min: int, size_max: int,
                                eps: float = 0.05, iters: int = 200,
                                repair_passes: int = 8,
                                row_mask: Optional[torch.Tensor] = None,
                                mesh=None) -> ConstrainedAssignment:
    """Size-constrained assignment for the cost matrix [N, K] on its
    device.  ``cost`` is on the scale of unit-norm distances (the ConSSKM
    caller passes sqrt of squared distances, as the reference's MCF costs
    are); ``eps`` is relative to the cost's (population) std, taken over
    every row, pad rows included, as the JAX function takes it (a pad
    row of zero features costs the centers' norms).  ``row_mask`` and
    ``mesh``: see the module docstring."""
    ranks = _Ranks(mesh)
    cost = cost.float()
    c_std = ranks.std(cost).clamp_min(1e-6)
    cost_n = cost / c_std  # eps is hence relative to the cost std
    _f, g, n_dual = _sinkhorn_duals(cost_n, size_min, size_max, eps, iters,
                                    row_mask=row_mask, ranks=ranks)
    labels = torch.argmin(cost_n - g[None, :], dim=1)
    if row_mask is not None:
        labels = torch.where(row_mask, labels, torch.full_like(labels, k))
    # the repair exits once the counts are feasible: excess and deficit
    # are then zero, so further passes would change nothing
    feasible = _feasible(labels, k, size_min, size_max, ranks)
    it = 0
    while it < repair_passes and not feasible:
        labels = _evict_pass(cost_n, labels, g, size_min, size_max, k, ranks)
        labels = _steal_pass(cost_n, labels, g, size_min, size_max, k, ranks)
        feasible = _feasible(labels, k, size_min, size_max, ranks)
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
