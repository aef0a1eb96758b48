"""Size-constrained (semi-supervised) k-means — ConSSKM.

Port of ``scd_tpu/cluster/constrained.py`` (reference
``local_utils/sskm_constrained.py``): Lloyd iterations whose E-step is a
constrained assignment forcing every cluster to hold ``size_min <= |c| <=
size_max`` unlabelled points; labelled points stay pinned to their class
centroid; k-means++ seeds the non-labelled centers; ``n_init`` restarts
keep the best inertia.

Two E-step tracks, chosen by ``ClusterConfig.constrained_backend``:

- ``"sinkhorn"`` (default): the entropic-OT assignment of
  ``ops/sinkhorn.py`` on the features' device.  The restarts run one after
  another, as the k-means port's do.  Each restart keeps its
  lexicographic (feasible, inertia) best iteration, and the run prefers
  feasible restarts.  When the chosen restart is infeasible the run goes
  on to the exact track, as the JAX package does (the algorithm's
  contract, not a device fallback), counted in
  ``fit_constrained.mcf_fallbacks``.
- ``"mcf"`` (exact): per Lloyd iteration the device computes the
  distances and the reference's int32 costs ``round(1000*sqrt(d))``
  (``sskm_constrained.py:324``; ``torch.round`` rounds half to even, as
  ``jnp.around`` does), the costs go to the host once, the host solver
  (``ops/native.py``) returns labels, and one device step computes the
  inertia against the distances the labels were solved on, the M-step,
  the shift and the next costs.  Restarts run in a thread pool
  (``mcf_restart_threads``; the ctypes call releases the GIL); every
  restart's initial centers are drawn from the one generator, in restart
  order, before any thread starts, and the best restart is chosen in
  restart order with a strict ``<``, so the result does not depend on
  scheduling.  The seconds spent in the solver and in the device step add
  up in ``fit_constrained.mcf_seconds``.

Seeds come from a ``torch.Generator`` seeded with ``ClusterConfig.seed``
(each track starts its own, as each JAX track splits the same key).
Device: as the k-means fitters (``cluster/kmeans.py::_device_f32``).

Over a ``mesh`` (``scd_tpu/cluster/constrained.py:248-336``, its
multi-controller contract) ``u_feats`` is THIS RANK's shard of the
unlabelled rows and the labelled set is the same full value on every rank
(checked): the shard pads to the ranks' common width and the pads are
masked (``cluster.kmeans._Shard``); k-means++ draws are distributed
(both seeders, ``ops/kpp.py``); each E-step is the Sinkhorn assignment
over the ranks (``ops/sinkhorn.py``: pad rows take the sentinel label k);
each Lloyd iteration merges the M-step sums, counts and inertia in ONE
packed ``all_reduce``, so every rank ranks the restarts by the same
(feasible, inertia) bits; the labels come back on every rank, labelled
first, then the unlabelled in shard order, pads removed.  Over more than
one rank the exact track needs the whole cost matrix on one host, so
``constrained_backend="mcf"`` and an infeasible Sinkhorn result raise the
JAX package's ``RuntimeError`` (it raises in the same places); a mesh of
one rank runs the mesh code on all rows and may go on to the exact
track.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from scd_tpu_torch.cluster.kmeans import (KMeansResult, _device_f32,
                                          _generator)
from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.core.mesh import check_mesh
from scd_tpu_torch.ops.distance import pairwise_sqdist
from scd_tpu_torch.ops.kpp import (kmeans_plus_plus,
                                   kmeans_plus_plus_local_trials)
from scd_tpu_torch.ops.native import constrained_assign
from scd_tpu_torch.ops.segment import segment_sums
from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign


def _resolve_local_trials(cfg: ClusterConfig, k: int) -> int:
    """0 = simple kpp; -1 = the vendored package's auto ``2 + int(log k)``
    (``k_means_constrained_.py:93-96``); >0 = explicit count."""
    t = cfg.kpp_local_trials
    return (2 + int(np.log(k))) if t < 0 else t


def _seed_centers(x, k, generator, local_trials: int, pre_centers=None,
                  shard=None):
    kw = {} if shard is None else {"n_valid": shard.local_mask,
                                   "mesh": shard.mesh}
    if local_trials > 0:
        return kmeans_plus_plus_local_trials(
            x, k, generator, n_local_trials=local_trials,
            pre_centers=pre_centers, **kw)
    return kmeans_plus_plus(x, k, generator, pre_centers=pre_centers, **kw)


class _Labelled:
    """The labelled side, constant across iterations and restarts: its
    per-class sums and counts [K], class centers [n_l_classes, D], and the
    labelled inertia against any centers."""

    def __init__(self, l: torch.Tensor, l_labels: torch.Tensor, k: int,
                 n_l_classes: int):
        self.l, self.l_labels = l, l_labels
        self.sums, self.counts = segment_sums(l, l_labels, k)
        self.centers = (self.sums / self.counts.clamp_min(1.0)[:, None]
                        )[:n_l_classes]

    def inertia(self, centers: torch.Tensor) -> torch.Tensor:
        diff = self.l - centers.index_select(0, self.l_labels)
        return (diff * diff).sum()


def _mstep(u, labels, centers, lab: _Labelled, k: int):
    """(new centers, shift^2): labelled + unlabelled sums; an empty
    cluster keeps its center."""
    sums, counts = segment_sums(u, labels, k)
    return _mstep_from(sums, counts, centers, lab)


def _mstep_from(sums, counts, centers, lab: _Labelled):
    """:func:`_mstep` from the unlabelled sums and counts."""
    sums = sums + lab.sums
    counts = counts + lab.counts
    new = sums / counts.clamp_min(1.0)[:, None]
    new = torch.where((counts < 0.5)[:, None], centers, new)
    shift = torch.sqrt(((new - centers) ** 2).sum(dim=1)).sum()
    return new, shift * shift


def _sinkhorn_estep(u, centers, lab: _Labelled, k: int,
                    cfg: ClusterConfig, shard=None):
    """(labels [n] int32, inertia, new centers, shift^2 tensor,
    feasible) of one Lloyd iteration on the Sinkhorn E-step.  Over a mesh
    (``shard``) the labels are the rank's rows (k on its pads) and the
    M-step sums, counts and inertia merge in one packed ``all_reduce``."""
    d = pairwise_sqdist(u, centers)
    mesh, row_w = (None, None) if shard is None else (shard.mesh,
                                                      shard.row_w)
    assign = sinkhorn_constrained_assign(
        torch.sqrt(d), k, cfg.size_min, cfg.size_max,
        eps=cfg.sinkhorn_epsilon, iters=cfg.sinkhorn_iters,
        row_mask=None if row_w is None else row_w > 0, mesh=mesh)
    # pads carry the sentinel k: clamp the gather, weight them 0
    lab_ix = assign.labels.long().clamp_max(k - 1)
    picked = d.gather(1, lab_ix[:, None])[:, 0]
    if row_w is not None:
        picked = picked * row_w
    sums, counts = segment_sums(u, lab_ix, k, weights=row_w)
    part = picked.sum()
    if mesh is not None:
        from scd_tpu_torch.core.multihost import all_reduce

        packed = all_reduce(torch.cat([sums.reshape(-1), counts,
                                       part.reshape(1)]),
                            group=mesh.data_group)
        sums, counts, part = (packed[:-k - 1].view_as(sums),
                              packed[-k - 1:-1], packed[-1])
    inertia = float(part + lab.inertia(centers))
    new_centers, shift_t = _mstep_from(sums, counts, centers, lab)
    return assign.labels, inertia, new_centers, shift_t, assign.feasible


def _sinkhorn_restart(u, centers, lab: _Labelled, k: int,
                      cfg: ClusterConfig, shard=None):
    """One restart's Lloyd loop on the Sinkhorn E-step.  Returns (labels,
    inertia, centers, n_iter, feasible) of its best iteration, ranked
    lexicographically by (feasible, inertia): an infeasible E-step tends
    to have the lower inertia, so inertia alone would prefer it."""
    tol32 = float(np.float32(cfg.tolerance))
    best = (torch.zeros(u.shape[0], dtype=torch.int32, device=u.device),
            float("inf"), centers, False)
    it, shift_sq = 0, float("inf")
    while it < cfg.max_iterations and shift_sq >= tol32:
        labels, inertia, new_centers, shift_t, feasible = _sinkhorn_estep(
            u, centers, lab, k, cfg, shard)
        rank_new = inertia if feasible else float("inf")
        rank_old = best[1] if best[3] else float("inf")
        better = (inertia < best[1]) if rank_new == rank_old \
            else rank_new < rank_old
        if better:
            best = (labels, inertia, new_centers, feasible)
        shift_sq = float(shift_t)
        centers = new_centers
        it += 1
    return best[0], best[1], best[2], it, best[3]


def _fit_sinkhorn(u, lab: _Labelled, k: int, cfg: ClusterConfig,
                  shard=None):
    """Restarts one after another; the feasible restart of least inertia,
    or the least inertia of all when none is feasible (first on ties)."""
    gen = _generator(cfg, u.device)
    local_trials = _resolve_local_trials(cfg, k)
    runs = []
    for _ in range(cfg.n_init):
        centers0 = _seed_centers(u, k, gen, local_trials,
                                 pre_centers=lab.centers, shard=shard)
        runs.append(_sinkhorn_restart(u, centers0, lab, k, cfg, shard))
    feas = [r[4] for r in runs]
    ranked = [r[1] if (r[4] or not any(feas)) else float("inf")
              for r in runs]
    return runs[int(np.argmin(ranked))]


def _costs(d: torch.Tensor) -> torch.Tensor:
    """The reference's int32 cost rounding, ``round(1000*sqrt(dist))``."""
    return torch.round(torch.sqrt(d) * 1000.0).to(torch.int32)


def _mcf_device_step(u, centers, d, labels, lab: _Labelled, k: int):
    """The device side of one Lloyd iteration: the inertia of the solver's
    labels against the distances they were solved on, the M-step, the
    shift, and the next iteration's distances and rounded costs."""
    picked = d.gather(1, labels[:, None])[:, 0]
    inertia = picked.sum() + lab.inertia(centers)
    new_centers, shift_sq = _mstep(u, labels, centers, lab, k)
    d_next = pairwise_sqdist(u, new_centers)
    return new_centers, d_next, _costs(d_next), torch.stack(
        [inertia, shift_sq])


def _mcf_restart(u, centers, lab: _Labelled, k: int, cfg: ClusterConfig):
    """One restart on the exact E-step.  Returns (labels, inertia,
    centers, n_iter, (solver seconds, device seconds)); the device seconds
    include the cost matrix's copy to the host."""
    t0 = time.perf_counter()
    d = pairwise_sqdist(u, centers)
    costs_host = _costs(d).cpu().numpy()
    t_dev = time.perf_counter() - t0
    t_solve = 0.0
    best_labels, best_inertia, best_centers = None, np.inf, None
    it = 0
    for it in range(1, cfg.max_iterations + 1):
        t0 = time.perf_counter()
        labels = constrained_assign(costs_host, cfg.size_min, cfg.size_max)
        t1 = time.perf_counter()
        centers_new, d, costs, scalars = _mcf_device_step(
            u, centers, d, torch.as_tensor(labels.astype(np.int64),
                                           device=u.device), lab, k)
        costs_host = costs.cpu().numpy()
        inertia, shift_sq = (float(v) for v in scalars.cpu().numpy())
        t_solve += t1 - t0
        t_dev += time.perf_counter() - t1
        if inertia < best_inertia:
            best_labels, best_inertia, best_centers = (labels, inertia,
                                                       centers_new)
        centers = centers_new
        if shift_sq < cfg.tolerance:
            break
    return best_labels, best_inertia, best_centers, it, (t_solve, t_dev)


def _fit_mcf(u, lab: _Labelled, k: int, cfg: ClusterConfig):
    """The exact track's restarts, concurrently; the least inertia in
    restart order (strict ``<``)."""
    gen = _generator(cfg, u.device)
    local_trials = _resolve_local_trials(cfg, k)
    starts = [_seed_centers(u, k, gen, local_trials, pre_centers=lab.centers)
              for _ in range(cfg.n_init)]
    n = len(starts)
    workers = (cfg.mcf_restart_threads if cfg.mcf_restart_threads > 0
               else min(n, 4))

    def run(c0):
        return _mcf_restart(u, c0, lab, k, cfg)

    if workers == 1 or n == 1:
        results = [run(c0) for c0 in starts]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(run, starts))
    best = None
    for r in results:
        fit_constrained.mcf_seconds[0] += r[4][0]
        fit_constrained.mcf_seconds[1] += r[4][1]
        fit_constrained.mcf_iterations += r[3]
        if best is None or r[1] < best[1]:
            best = r
    return best[:4]


def _check_bounds(n: int, k: int, cfg: ClusterConfig, what: str) -> None:
    if cfg.size_min * k > n or cfg.size_max * k < n:
        raise ValueError(what)


def _fit(u, lab: _Labelled, k: int, cfg: ClusterConfig, shard=None
         ) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """Either track; the Sinkhorn track goes on to the exact one when its
    chosen restart is infeasible (over more than one rank it raises).
    Returns host (labels, centers, inertia, n_iter); over a mesh the
    labels of every rank's real rows."""
    over_ranks = shard is not None and shard.mesh.size > 1
    if cfg.constrained_backend == "sinkhorn":
        labels, inertia, centers, n_iter, feasible = _fit_sinkhorn(
            u, lab, k, cfg, shard)
        if feasible:
            labels = (labels.cpu().numpy() if shard is None
                      else shard.fetch(labels))
            return labels, centers.cpu().numpy(), inertia, n_iter
        if over_ranks:
            raise RuntimeError(
                "constrained sinkhorn E-step infeasible under "
                "multi-controller execution; the exact MCF fallback needs "
                "the full cost matrix on one host — loosen size bounds or "
                "raise sinkhorn_iters")
        fit_constrained.mcf_fallbacks += 1
    elif cfg.constrained_backend != "mcf":
        raise ValueError(f"unknown constrained_backend "
                         f"{cfg.constrained_backend!r}")
    # a mesh of one rank holds every row and no pad
    labels, inertia, centers, n_iter = _fit_mcf(u, lab, k, cfg)
    return labels, centers.cpu().numpy(), inertia, n_iter


def fit_constrained(u_feats, l_feats, l_targets, cfg: ClusterConfig,
                    device=None, mesh=None) -> KMeansResult:
    """ConSSKM ``fit_mix``: labelled pinned + size-constrained unlabelled
    E-step (reference ``sskm_constrained.py:87-139,165-187``).

    Returned labels follow the reference contract: labelled instances
    first (remapped class ids from ``np.unique``), then the unlabelled
    assignments.  ``device`` as in ``fit_sskm``, decided by ``u_feats``.
    With a ``mesh`` (see the module docstring) ``u_feats`` is this rank's
    shard of the unlabelled rows and ``l_feats`` / ``l_targets`` the same
    full labelled set on every rank.
    """
    from scd_tpu_torch.cluster.kmeans import _rows_in

    mesh = check_mesh(mesh)
    if (mesh is not None and mesh.size > 1
            and cfg.constrained_backend != "sinkhorn"):
        raise RuntimeError(
            "multi-controller fit_constrained supports only the sinkhorn "
            "backend (the exact MCF solver is a host algorithm over the "
            "full cost matrix); mesh=None stays a process-local run")
    u, shard = _rows_in(u_feats, device, mesh)
    dev = u.device
    l = _device_f32(l_feats, dev)
    l_targets = np.asarray(l_targets).astype(np.int64)
    if shard is not None:
        from scd_tpu_torch.core.multihost import replicate_to_mesh

        replicate_to_mesh(shard.mesh, [l, l_targets])
    k = cfg.n_clusters
    n_u = u.shape[0] if shard is None else shard.n_valid
    classes, l_mapped = np.unique(l_targets, return_inverse=True)
    n_l_classes = len(classes)
    if k < n_l_classes:
        raise ValueError(f"n_clusters={k} < labelled classes {n_l_classes}")
    _check_bounds(n_u, k, cfg,
                  f"infeasible size constraints for {n_u} unlabelled "
                  f"points: k={k}, size_min={cfg.size_min}, "
                  f"size_max={cfg.size_max}")
    lab = _Labelled(l, torch.as_tensor(l_mapped.astype(np.int64),
                                       device=dev), k, n_l_classes)
    labels, centers, inertia, n_iter = _fit(u, lab, k, cfg, shard)
    all_labels = np.concatenate([l_mapped.astype(np.int32),
                                 labels.astype(np.int32)])
    return KMeansResult(all_labels, centers, float(inertia), int(n_iter))


# restarts that went on from the Sinkhorn track to the exact one; the
# exact track's [solver, device step] seconds and its Lloyd iterations
fit_constrained.mcf_fallbacks = 0
fit_constrained.mcf_seconds = [0.0, 0.0]
fit_constrained.mcf_iterations = 0


def fit_constrained_unsup(x, cfg: ClusterConfig,
                          device=None) -> KMeansResult:
    """Fully-unsupervised constrained k-means (reference ``fit_once``,
    ``sskm_constrained.py:47-85``): the same E-step, k-means++ from
    scratch.  ``device`` as in :func:`fit_constrained`."""
    x_t = _device_f32(x, device)
    k = cfg.n_clusters
    _check_bounds(x_t.shape[0], k, cfg, "infeasible size constraints")
    lab = _Labelled(x_t[:0], torch.zeros(0, dtype=torch.int64,
                                         device=x_t.device), k, 0)
    labels, centers, inertia, n_iter = _fit(x_t, lab, k, cfg)
    return KMeansResult(np.asarray(labels, np.int32), centers,
                        float(inertia), int(n_iter))


def reset_counters() -> None:
    """Zero ``fit_constrained``'s fallback count, seconds and iterations."""
    fit_constrained.mcf_fallbacks = 0
    fit_constrained.mcf_seconds = [0.0, 0.0]
    fit_constrained.mcf_iterations = 0
