"""K-means and semi-supervised k-means (SSKM).

Port of ``scd_tpu/cluster/kmeans.py`` (reference
``faster_mix_k_means_pytorch.py``, ``sskm_constrained.py`` minus the size
constraint):

- k-means++ init (optionally seeded with labelled class means),
- Lloyd iterations with best-inertia tracking and a
  ``center_shift**2 < tol`` stopping rule,
- ``n_init`` restarts with best-inertia selection.

The JAX package vmaps the restarts inside one ``while_loop``; here they are
an explicit loop, and each restart stops by its own condition, as each
vmapped lane does.  Every EM iteration is one launch of the fused kernel on
a CUDA device (``ops.em``) and the plain version on the CPU.  Features stay
on the device for the whole fit; one scalar per iteration (the center
shift) comes back to the host for the stopping test.

Over a ``mesh`` (``core/mesh.py``, ``scd_tpu/cluster/kmeans.py:56-82,
335-560``) a row input is THIS RANK's shard: ragged shares pad to a common
width and the pads are masked out of seeding and sums
(``core.multihost.rows_from_process_local``); labelled side inputs are the
same full value on every rank (checked); each Lloyd iteration is
``ops.em.em_iteration_sharded`` (the kernel on the rank's rows, one
``all_reduce``); k-means++ draws are distributed (``ops.kpp``); every rank
picks the same best restart from the all-reduced inertia, and the labels
come back on every rank, in the order of the ranks' shards.

Device of the fitters (``fit_kmeans``, ``fit_sskm``,
``fit_kmeans_from_labels``): ``device="cuda"`` or ``"cpu"`` when given;
otherwise a tensor input stays on its own device and a numpy input goes
to the card, raising when there is none (``core.device.resolve_device``).
``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.core.mesh import check_mesh
from scd_tpu_torch.ops.distance import pairwise_sqdist
from scd_tpu_torch.ops.em import em_iteration, em_iteration_sharded
from scd_tpu_torch.ops.kpp import kmeans_plus_plus
from scd_tpu_torch.ops.segment import segment_sums


@dataclasses.dataclass
class KMeansResult:
    labels: np.ndarray  # [N] int32 — for SSKM: concat(labelled, unlabelled) order
    centers: np.ndarray  # [K, D] f32
    inertia: float
    n_iter: int


def _device_f32(x, device=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a contiguous f32 tensor on ``device``.
    With no ``device`` a tensor stays where it is and numpy goes to the
    card (``resolve_device("cuda")``, which raises without one), as the JAX
    package's fitters run on the default backend."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(resolve_device(device))
        return t.float().contiguous()
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(resolve_device("cuda" if device is None else device))


def _lloyd_loop(x: torch.Tensor, centers0: torch.Tensor, k: int,
                max_iter: int, tol: float,
                row_w: Optional[torch.Tensor] = None,
                extra_sums: Optional[torch.Tensor] = None,
                extra_counts: Optional[torch.Tensor] = None,
                extra_inertia_fn: Optional[Callable] = None,
                fused: Optional[bool] = None,
                estep: Tuple[int, bool] = (3, False), mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Shared Lloyd iteration engine (``scd_tpu/cluster/kmeans.py:100``).

    ``row_w`` [N] weights (0 drops a row).  ``extra_sums``/``extra_counts``
    add a constant labelled contribution to the M-step; ``extra_inertia_fn``
    maps centers -> scalar labelled inertia.  Returns
    (best_labels, best_inertia, best_centers, n_iter), where best_labels
    are the labels computed with the centers BEFORE the best iteration's
    update and best_centers the centers after it, as in the JAX loop.
    ``estep`` = (estep_passes, x_bf16) of the fused kernel.  With a
    ``mesh``, ``x`` is this rank's shard and each iteration merges over the
    data axis (``em_iteration_sharded``); labels stay local.
    """
    n = x.shape[0]
    estep_passes, x_bf16 = estep
    if x_bf16 and x.is_cuda:
        x = x.to(torch.bfloat16)  # once, not per iteration
    # the JAX loop compares its f32 shift with tol rounded to f32
    tol32 = float(np.float32(tol))
    dev = x.device
    centers = centers0.float()
    best_labels = torch.zeros(n, dtype=torch.int32, device=dev)
    best_inertia = torch.full((), float("inf"), device=dev)
    best_centers = centers
    it, shift_sq = 0, float("inf")
    while it < max_iter and shift_sq >= tol32:
        if mesh is not None:
            labels, sums, counts, inertia = em_iteration_sharded(
                x, centers, row_w, mesh, estep_passes=estep_passes,
                x_bf16=x_bf16, fused=fused)
        else:
            labels, sums, counts, inertia = em_iteration(
                x, centers, k, row_w=row_w, fused=fused,
                estep_passes=estep_passes, x_bf16=x_bf16)
        if extra_inertia_fn is not None:
            inertia = inertia + extra_inertia_fn(centers)
        if extra_sums is not None:
            sums = sums + extra_sums
            counts = counts + extra_counts
        new_centers = sums / counts.clamp_min(1.0)[:, None]
        # empty cluster: keep previous center
        new_centers = torch.where((counts < 0.5)[:, None], centers,
                                  new_centers)
        better = inertia < best_inertia
        best_labels = torch.where(better, labels, best_labels)
        best_inertia = torch.where(better, inertia, best_inertia)
        best_centers = torch.where(better, new_centers, best_centers)
        shift = torch.sqrt(((new_centers - centers) ** 2).sum(dim=1)).sum()
        shift_sq = float(shift * shift)
        centers = new_centers
        it += 1
    return best_labels, best_inertia, best_centers, it


def _best_restart(runs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 int]:
    """The restart with the lowest inertia; the first one on a tie."""
    best = int(torch.argmin(torch.stack([r[1] for r in runs])))
    return runs[best]


def _use_fused(cfg_fused, device: torch.device) -> bool:
    """Fused E+M kernel dispatch (``ClusterConfig.fused_mesh``): "auto"
    picks the kernel on a CUDA device and the plain version on the CPU;
    True/False force either.  The SCD_FUSED_MESH env var overrides the
    config when set ("0"/"" = off).  On a CUDA device "off" raises: a CUDA
    tensor never reaches the plain version.  No size guard: the kernel
    tiles K and D, so every shape fits."""
    env = os.environ.get("SCD_FUSED_MESH")
    if env is not None:
        choice = env not in ("", "0")
    elif cfg_fused == "auto":
        choice = device.type == "cuda"
    else:
        choice = bool(cfg_fused)
    if device.type == "cuda" and not choice:
        raise ValueError("fused_mesh=False on a CUDA device: the plain EM "
                         "version runs on the CPU only")
    return choice


_ESTEP_PROBE_MEMO: dict = {}


def _estep_probe(x: torch.Tensor, cidx: np.ndarray, rows=None):
    """One EM iteration with exact and ``x_bf16`` x on the SAME data and
    centers, plus an exact top-2 distance pass.  Returns (n_flips,
    max_flip_margin, dist_scale): disagreeing valid rows, the largest
    exact squared-distance margin (d2 - d1) among them, and the mean
    per-point min squared distance.  Probe centers are the valid rows
    ``cidx`` (strided real rows — the near-tie structure a k-means++ init
    sees).  Over a mesh (``rows``: the shard's :class:`_Shard`) each rank
    compares its own rows and the counts, sums and maxima merge in ONE
    ``all_reduce``."""
    k = len(cidx)
    if rows is None:
        cs = x.index_select(0, torch.as_tensor(cidx, device=x.device))
    else:
        cs = rows.rows_at(cidx)
    lab_ref = em_iteration(x, cs, k, fused=True)[0]
    lab_fast = em_iteration(x, cs, k, fused=True, x_bf16=True)[0]
    neg_top2 = torch.topk(-pairwise_sqdist(x, cs), 2, dim=1).values
    mindist = -neg_top2[:, 0]
    margin = neg_top2[:, 0] - neg_top2[:, 1]
    flips = (lab_ref != lab_fast).float()
    if rows is None:
        return (float(flips.sum()), float((margin * flips).max()),
                float(mindist.mean()))
    w = rows.row_w if rows.row_w is not None else torch.ones_like(flips)
    flips = flips * w
    mesh = rows.mesh
    # one all_reduce: [flips, sum of min distances, each rank's max margin
    # in its own slot]
    packed = torch.zeros(2 + mesh.n_data, device=x.device)
    packed[0] = flips.sum()
    packed[1] = (mindist * w).sum()
    packed[2 + mesh.data_index] = (margin * flips).max()
    from scd_tpu_torch.core.multihost import all_reduce

    packed = all_reduce(packed, group=mesh.data_group).cpu()
    return (float(packed[0]), float(packed[2:].max()),
            float(packed[1]) / max(rows.n_valid, 1))


def _resolve_estep(cfg: ClusterConfig, fused: bool, x: torch.Tensor,
                   rows=None) -> Tuple[int, bool]:
    """Map ``ClusterConfig.estep`` to ``(estep_passes, x_bf16)`` for THIS
    fit (``scd_tpu/cluster/kmeans.py:262-332``, unchanged):

    - not ``fused``: the plain path is exact — (3, False);
    - ``"exact"`` -> (3, False); ``"2pass"`` -> (2, False);
      ``"x_bf16"`` -> (3, True);
    - ``"auto"``: one probe EM iteration over the actual features compares
      x_bf16 with exact labels on every row.  Take (3, True) on full
      agreement, or when every disagreement is a sub-resolution tie: exact
      margin at most 1% of the mean per-point min squared distance AND at
      most 2% of rows flipped.  Memoized per (shape, K, device type, mesh
      size).  Over a mesh (``rows``) the probe runs on every rank's shard.

    ``SCD_ESTEP`` env var overrides the config when set.
    """
    mode = os.environ.get("SCD_ESTEP") or cfg.estep
    if mode not in ("auto", "exact", "x_bf16", "2pass"):
        raise ValueError(f"unknown ClusterConfig.estep {mode!r}")
    if not fused or mode == "exact":
        return (3, False)
    if mode == "2pass":
        return (2, False)
    if mode == "x_bf16":
        return (3, True)

    k = cfg.n_clusters
    n_real = x.shape[0] if rows is None else rows.n_valid
    memo_key = ((n_real,) + tuple(x.shape[1:]), k, x.device.type) + (
        () if rows is None else (rows.mesh.size,))
    hit = _ESTEP_PROBE_MEMO.get(memo_key)
    if hit is not None:
        return hit
    if n_real < max(k, 2):  # degenerate fit; let the fitter raise/handle it
        return (3, False)
    pick = np.linspace(0, n_real - 1, k).round().astype(np.int64)
    n_flips, max_margin, scale = _estep_probe(x, pick, rows)
    ties_only = max_margin <= 0.01 * scale and n_flips <= 0.02 * n_real
    estep = (3, True) if (n_flips == 0 or ties_only) else (3, False)
    logging.getLogger("scd_tpu_torch.estep").info(
        "estep auto probe: N=%d D=%d K=%d flips=%d max_flip_margin=%.3e "
        "dist_scale=%.3e -> %s", n_real, x.shape[1], k, int(n_flips),
        max_margin, scale, "x_bf16 fast path" if estep[1] else "exact")
    _ESTEP_PROBE_MEMO[memo_key] = estep
    return estep


def _generator(cfg: ClusterConfig, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(cfg.seed)


class _Shard:
    """This rank's part of a row input to a mesh fitter
    (``_stage_rows_ragged`` of the JAX package): ``x`` the padded local
    rows on the device, ``row_w`` their 0/1 f32 weights (None when no rank
    was padded), ``valid`` the global host mask (None likewise),
    ``n_valid`` the global count of real rows."""

    def __init__(self, x, mesh, device=None, dtype=np.float32):
        from scd_tpu_torch.core.multihost import (local_valid,
                                                  rows_from_process_local)

        self.mesh = mesh
        dev = mesh.device if device is None else resolve_device(device)
        if isinstance(x, torch.Tensor):
            x = x.to(dev)
        else:
            x = np.asarray(x, dtype)
        self.x, self.valid = rows_from_process_local(mesh, x, pad=True,
                                                     device=dev)
        if dtype == np.float32:
            self.x = self.x.float().contiguous()
        lv = local_valid(mesh, self.valid)
        self.local_mask = lv
        self.row_w = None if lv is None else torch.as_tensor(
            lv, dtype=torch.float32, device=dev)
        self.n_valid = (int(self.valid.sum()) if self.valid is not None
                        else self.x.shape[0] * mesh.n_data)

    def rows_at(self, idx: np.ndarray) -> torch.Tensor:
        """The valid rows of global (unpadded) indices ``idx`` [T, D], on
        every rank: each owner fills its rows, one ``all_reduce`` sums."""
        from scd_tpu_torch.core.multihost import all_reduce, gather_counts

        n_here = self.x.shape[0] if self.local_mask is None else int(
            self.local_mask.sum())
        counts = gather_counts(self.mesh, n_here)
        lo = int(counts[:self.mesh.data_index].sum())
        mine = np.flatnonzero((idx >= lo) & (idx < lo + n_here))
        pos = (np.arange(self.x.shape[0]) if self.local_mask is None
               else np.flatnonzero(self.local_mask))
        out = self.x.new_zeros((len(idx), self.x.shape[1]))
        if len(mine):
            out[torch.as_tensor(mine, device=out.device)] = self.x.index_select(
                0, torch.as_tensor(pos[idx[mine] - lo], device=out.device))
        return all_reduce(out, group=self.mesh.data_group)

    def fetch(self, labels: torch.Tensor) -> np.ndarray:
        """Labels of every real row, in shard order, on every rank."""
        from scd_tpu_torch.core.multihost import host_fetch

        lab = host_fetch(labels, self.mesh)
        return lab if self.valid is None else lab[self.valid]


def _rows_in(x, device, mesh):
    """(device f32 rows, shard or None) of a fitter's row input."""
    mesh = check_mesh(mesh)
    if mesh is None:
        return _device_f32(x, device), None
    shard = _Shard(x, mesh, device)
    return shard.x, shard


def fit_kmeans(x, cfg: ClusterConfig, device=None, mesh=None) -> KMeansResult:
    """Plain unsupervised k-means (reference baseline at
    ``main_unsup.py:362``).  ``x`` is numpy or a tensor; ``device``
    defaults to where a tensor already lives, and to the card for numpy
    (see the module docstring); ``device="cpu"`` runs the plain versions.
    With a ``mesh`` (see the module docstring) ``x`` is this rank's shard
    and ``device`` defaults to the rank's own."""
    x_t, shard = _rows_in(x, device, mesh)
    mesh = None if shard is None else shard.mesh
    k = cfg.n_clusters
    fused = _use_fused(cfg.fused_mesh, x_t.device)
    estep = _resolve_estep(cfg, fused, x_t, shard)
    row_w = None if shard is None else shard.row_w
    valid = None if shard is None else shard.local_mask
    gen = _generator(cfg, x_t.device)
    runs = []
    for _ in range(cfg.n_init):
        centers0 = kmeans_plus_plus(x_t, k, gen, n_valid=valid, mesh=mesh)
        runs.append(_lloyd_loop(x_t, centers0, k, cfg.max_iterations,
                                cfg.tolerance, row_w=row_w, fused=fused,
                                estep=estep, mesh=mesh))
    labels, inertia, centers, n_iter = _best_restart(runs)
    lab = labels.cpu().numpy() if shard is None else shard.fetch(labels)
    return KMeansResult(lab, centers.cpu().numpy(), float(inertia),
                        int(n_iter))


def fit_sskm(u_feats, l_feats, l_targets, cfg: ClusterConfig,
             device=None, mesh=None) -> KMeansResult:
    """Semi-supervised k-means: labelled points are pinned to their class
    centroid; the first ``n_labelled_classes`` centroids are seeded from
    labelled class means (reference ``fit_mix_once``,
    ``faster_mix_k_means_pytorch.py:161-216``).

    Returned ``labels`` follow the reference contract: labelled instances
    first (their remapped class ids), then unlabelled assignments.
    ``device`` as in :func:`fit_kmeans`, decided by ``u_feats``.  With a
    ``mesh``, ``u_feats`` is this rank's shard of the unlabelled rows and
    ``l_feats`` / ``l_targets`` the same full labelled set on every rank.
    """
    u, shard = _rows_in(u_feats, device, mesh)
    mesh = None if shard is None else shard.mesh
    dev = u.device
    l = _device_f32(l_feats, dev)
    l_targets = np.asarray(l_targets).astype(np.int64)
    if mesh is not None:
        from scd_tpu_torch.core.multihost import replicate_to_mesh

        replicate_to_mesh(mesh, [l, l_targets])
    classes, l_mapped = np.unique(l_targets, return_inverse=True)
    n_l_classes = len(classes)
    k = cfg.n_clusters
    if k < n_l_classes:
        raise ValueError(f"n_clusters={k} < labelled classes {n_l_classes}")
    l_lab = torch.as_tensor(l_mapped.astype(np.int64), device=dev)

    fused = _use_fused(cfg.fused_mesh, dev)
    estep = _resolve_estep(cfg, fused, u, shard)

    # labelled structure is constant across iterations and restarts
    l_sums, l_counts = segment_sums(l, l_lab, k)
    l_centers = (l_sums / l_counts.clamp_min(1.0)[:, None])[:n_l_classes]

    def l_inertia_fn(centers):
        diffs = l - centers.index_select(0, l_lab)
        return (diffs * diffs).sum()

    row_w = None if shard is None else shard.row_w
    valid = None if shard is None else shard.local_mask
    gen = _generator(cfg, dev)
    runs = []
    for _ in range(cfg.n_init):
        centers0 = kmeans_plus_plus(u, k, gen, pre_centers=l_centers,
                                    n_valid=valid, mesh=mesh)
        runs.append(_lloyd_loop(u, centers0, k, cfg.max_iterations,
                                cfg.tolerance, row_w=row_w,
                                extra_sums=l_sums, extra_counts=l_counts,
                                extra_inertia_fn=l_inertia_fn,
                                fused=fused, estep=estep, mesh=mesh))
    u_labels, inertia, centers, n_iter = _best_restart(runs)
    u_lab = u_labels.cpu().numpy() if shard is None else shard.fetch(u_labels)
    all_labels = np.concatenate([l_mapped.astype(np.int32), u_lab])
    return KMeansResult(all_labels, centers.cpu().numpy(), float(inertia),
                        int(n_iter))


def fit_kmeans_from_labels(x, init_labels, cfg: ClusterConfig,
                           device=None, mesh=None) -> KMeansResult:
    """K-means warm-started from an existing labelling (e.g. a supervised
    classifier's predictions).  Deterministic: a single Lloyd run from the
    label centroids, no k-means++ restarts.  ``device`` as in
    :func:`fit_kmeans`.  With a ``mesh``, ``x`` and ``init_labels`` are
    this rank's shards (same rows, same order)."""
    x_t, shard = _rows_in(x, device, mesh)
    k = cfg.n_clusters
    fused = _use_fused(cfg.fused_mesh, x_t.device)
    estep = _resolve_estep(cfg, fused, x_t, shard)
    if shard is None:
        lab = torch.as_tensor(np.asarray(init_labels, np.int64),
                              device=x_t.device)
        sums, counts = segment_sums(x_t, lab, k)
        mesh, row_w = None, None
    else:
        from scd_tpu_torch.core.multihost import all_reduce

        mesh, row_w = shard.mesh, shard.row_w
        lab = _Shard(np.asarray(init_labels, np.int64), mesh,
                     x_t.device, np.int64).x
        sums, counts = segment_sums(x_t, lab, k, weights=row_w)
        packed = all_reduce(torch.cat([sums.reshape(-1), counts]),
                            group=mesh.data_group)
        sums, counts = packed[:-k].view(k, -1), packed[-k:]
    centers0 = sums / counts.clamp_min(1.0)[:, None]
    labels, inertia, centers, n_iter = _lloyd_loop(
        x_t, centers0, k, cfg.max_iterations, cfg.tolerance, row_w=row_w,
        fused=fused, estep=estep, mesh=mesh)
    lab_out = labels.cpu().numpy() if shard is None else shard.fetch(labels)
    return KMeansResult(lab_out, centers.cpu().numpy(), float(inertia),
                        int(n_iter))
