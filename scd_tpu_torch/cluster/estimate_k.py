"""Estimate the number of clusters K.

Port of ``scd_tpu/cluster/estimate_k.py`` (reference
``gcd/methods/estimate_k/estimate_k.py``): treat "ACC on the labelled
subset after clustering all features with K clusters" as a black-box
objective of K and search over ``[num_labeled_classes, max_classes]`` by
halving search (:172-218) or scipy's bounded Brent ``minimize_scalar``
(:221-242).

Each probe of K runs k-means over ``max_k`` center slots, slots at or past
K holding a far sentinel that never wins the argmin, as the JAX package
does to keep one compiled shape for every K.  So every EM iteration of a
probe runs the ``fused_em_step`` kernel (``csrc/fused_em.cu``) at K =
``max_k`` on a CUDA device, and the plain version on the CPU.  The
restarts run one after another on one ``torch.Generator`` seeded from the
objective's ``seed``, made afresh for every probe, as every JAX probe
starts from ``PRNGKey(seed)``.

Over a ``mesh`` (``scd_tpu/cluster/estimate_k.py:163-214, 288-297``)
the feature rows are THIS RANK's shard (ragged shares pad to a common
width, the pads masked out of seeding and sums: ``cluster.kmeans.
_Shard``), staged and normalised once for the whole search; the seeding
is the distributed k-means++ draw from every rank's copy of the same
generator (``ops/kpp.py``), each EM iteration is ``fused_em_step`` on the
rank's rows at ``max_k`` slots merged by ``ops.em.em_iteration_sharded``
(one ``all_reduce`` of the ``k_active`` live slots' sums and counts: the
sentinels' are zero on every rank), and the labels come back on every
rank in shard order, so ``targets`` / ``mask_lab`` are the global
arrays.

``python -m scd_tpu_torch.cluster.estimate_k`` takes the JAX CLI's flags
plus ``--device`` (``cuda`` unless asked for ``cpu``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from scd_tpu_torch.cluster.kmeans import _device_f32, fit_kmeans
from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.core.mesh import check_mesh, single_rank
from scd_tpu_torch.metrics.cluster import cluster_acc
from scd_tpu_torch.ops.em import em_iteration_sharded
from scd_tpu_torch.ops.kpp import kmeans_plus_plus

SENTINEL = 1e12


def _kpp_masked(x: torch.Tensor, k_active: int, max_k: int,
                generator: torch.Generator, shard=None) -> torch.Tensor:
    """k-means++ over ``max_k`` slots [max_k, D]: the first ``k_active``
    are the draws of :func:`kmeans_plus_plus` (over a mesh, ``shard``: the
    distributed draws, pads never drawn), the rest a far sentinel (1e12 in
    every coordinate) so the E-step never assigns to them.  The JAX loop
    also runs the steps ``k_active..max_k-1`` to keep one compiled shape,
    but they change neither the centers nor the distances, so this one
    stops at ``k_active``."""
    k = min(max(int(k_active), 1), max_k)
    centers = torch.full((max_k, x.shape[1]), SENTINEL, dtype=torch.float32,
                         device=x.device)
    kw = {} if shard is None else {"n_valid": shard.local_mask,
                                   "mesh": shard.mesh}
    centers[:k] = kmeans_plus_plus(x, k, generator, **kw)
    return centers


def _dynk_run(x: torch.Tensor, k_active: int, max_k: int,
              max_iterations: int, n_init: int, generator: torch.Generator,
              shard=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels [N] int32, inertia 0-d, centers [max_k, D]) of the best of
    ``n_init`` restarts, on ``x``'s device.  Each restart runs exactly
    ``max_iterations`` EM iterations (the JAX ``fori_loop``: no tolerance
    exit); an empty slot keeps its center.  Labels and inertia are those of
    the last iteration, computed before its update.  The best restart is
    the first at the lowest inertia.  Each iteration is one
    ``em_iteration_sharded`` (``em_iteration`` without a mesh): the kernel
    on a CUDA device, the plain version on the CPU; over a mesh
    (``shard``) on the rank's rows, merged (the labels stay the rank's,
    the inertia is global).  Nothing is read to the host."""
    live = min(max(int(k_active), 1), max_k)  # the rest stay sentinels
    runs = []
    for _ in range(n_init):
        centers = (_kpp_masked(x, k_active, max_k, generator)
                   if shard is None else
                   _kpp_masked(x, k_active, max_k, generator, shard))
        labels = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        inertia = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(max_iterations):
            labels, sums, counts, inertia = em_iteration_sharded(
                x, centers, None if shard is None else shard.row_w,
                None if shard is None else shard.mesh, live=live)
            means = sums / counts.clamp_min(1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], means, centers)
        runs.append((labels, inertia, centers))
    best = int(torch.argmin(torch.stack([r[1] for r in runs])))
    return runs[best]


def _staged(x, device, mesh):
    """(f32 rows on the device, shard or None): the rank's padded shard
    over a mesh of more than one rank, else every row."""
    from scd_tpu_torch.cluster.kmeans import _Shard

    mesh = check_mesh(mesh)
    if single_rank(mesh):
        return _device_f32(x, device), None
    if isinstance(x, _Shard):
        return x.x, x
    shard = _Shard(x, mesh, device)
    return shard.x, shard


def fit_kmeans_dynamic_k(generator: torch.Generator, x, k_active: int,
                         max_k: int, n_init: int = 3,
                         max_iterations: int = 50, mesh=None,
                         device=None) -> Tuple[np.ndarray, float]:
    """K-means with ``k_active`` live slots out of ``max_k``: slots at or
    past ``k_active`` are far sentinels that never receive points.
    Returns (labels [N] numpy, inertia).  ``x`` is numpy or a tensor;
    ``device`` as in ``cluster.kmeans.fit_kmeans`` (a tensor stays where it
    is, numpy goes to the card); the draws come from ``generator``, which
    must live on that device.  Over a ``mesh`` ``x`` is this rank's shard
    (or a staged ``cluster.kmeans._Shard``) and the labels cover every
    rank's rows, in shard order, on every rank."""
    x_t, shard = _staged(x, device, mesh)
    labels, inertia, _ = _dynk_run(x_t, k_active, max_k, max_iterations,
                                   n_init, generator, shard)
    lab = labels.cpu().numpy() if shard is None else shard.fetch(labels)
    return lab, float(inertia)


def _normalized_device(all_feats, device=None) -> torch.Tensor:
    """L2-normalised f32 features on ``device``, computed there once."""
    x = _device_f32(all_feats, device)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def labelled_acc_objective_dynamic(all_feats, targets: np.ndarray,
                                   mask_lab: np.ndarray, max_k: int,
                                   n_init: int = 3,
                                   max_iterations: int = 50,
                                   seed: int = 0, mesh=None,
                                   device=None) -> Callable[[int], float]:
    """Objective(K) = ACC on the labelled rows after
    :func:`fit_kmeans_dynamic_k` with K live slots of ``max_k``.  The
    features are normalised and staged on ``device`` once; each probe
    reads the labels back once.  Over a ``mesh`` ``all_feats`` is this
    rank's row shard, staged and normalised once for the whole search,
    and ``targets`` / ``mask_lab`` are the global arrays."""
    x, shard = _staged(all_feats, device, mesh)
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if shard is not None:
        shard.x = x
    mask_lab = np.asarray(mask_lab, bool)
    targets = np.asarray(targets, np.int64)

    def objective(k: int) -> float:
        labels, _inertia = fit_kmeans_dynamic_k(
            torch.Generator(device=x.device).manual_seed(seed),
            x if shard is None else shard, int(k), max_k, n_init=n_init,
            max_iterations=max_iterations, mesh=mesh)
        return float(cluster_acc(targets[mask_lab], labels[mask_lab]))

    return objective


def labelled_acc_objective(all_feats, targets: np.ndarray,
                           mask_lab: np.ndarray, n_init: int = 3,
                           max_iterations: int = 50, seed: int = 0,
                           device=None) -> Callable[[int], float]:
    """Objective(K) = clustering ACC measured on labelled instances only
    (reference ``test_kmeans``, ``estimate_k.py:41-100``), one
    ``fit_kmeans`` of K clusters per probe."""
    x = _normalized_device(all_feats, device)  # once, not per probe
    mask_lab = np.asarray(mask_lab, bool)
    targets = np.asarray(targets, np.int64)

    def objective(k: int) -> float:
        cfg = ClusterConfig(n_clusters=int(k), n_init=n_init,
                            max_iterations=max_iterations, seed=seed)
        res = fit_kmeans(x, cfg)
        return float(cluster_acc(targets[mask_lab], res.labels[mask_lab]))

    return objective


def binary_search_k(objective: Callable[[int], float], min_k: int,
                    max_k: int, verbose: bool = False) -> Tuple[int, float]:
    """Halving search on the (assumed unimodal) ACC(K) curve
    (reference ``binary_search``, ``estimate_k.py:172-218``)."""
    small_k, big_k = min_k, max_k
    diff = big_k - small_k
    middle_k = int(0.5 * diff + small_k)

    acc_big = objective(big_k)
    acc_small = objective(small_k)
    acc_middle = objective(middle_k)
    best_k, best_acc = max(zip([small_k, middle_k, big_k],
                               [acc_small, acc_middle, acc_big]),
                           key=lambda kv: kv[1])
    if verbose:
        print(f"Iter 0: BigK {big_k}, Acc {acc_big:.4f} | MiddleK {middle_k}, "
              f"Acc {acc_middle:.4f} | SmallK {small_k}, Acc {acc_small:.4f}")

    for i in range(1, int(np.log2(max(diff, 2))) + 1):
        if acc_big > acc_small:
            small_k, acc_small = middle_k, acc_middle
        else:
            big_k, acc_big = middle_k, acc_middle
        diff = big_k - small_k
        middle_k = int(0.5 * diff + small_k)
        acc_middle = objective(middle_k)
        if acc_middle > best_acc:
            best_k, best_acc = middle_k, acc_middle
        if verbose:
            print(f"Iter {i}: BigK {big_k}, Acc {acc_big:.4f} | MiddleK "
                  f"{middle_k}, Acc {acc_middle:.4f} | SmallK {small_k}, "
                  f"Acc {acc_small:.4f}")
        if diff <= 1:
            break
    return best_k, best_acc


def scipy_optimise_k(objective: Callable[[int], float], min_k: int,
                     max_k: int) -> Tuple[int, float]:
    """Bounded Brent over K (reference ``scipy_optimise``,
    ``estimate_k.py:221-242``)."""
    from scipy.optimize import minimize_scalar

    res = minimize_scalar(lambda k: -objective(int(k)),
                          bounds=(min_k, max_k), method="bounded")
    # the optimizer only ever evaluated int(res.x) (truncation in the
    # lambda); return that K so the (K, acc) pair is the one measured
    best_k = int(res.x)
    return best_k, float(-res.fun)


def estimate_k(all_feats, targets: np.ndarray, mask_lab: np.ndarray,
               min_k: int, max_k: int, method: str = "binary",
               verbose: bool = False,
               objective: Optional[Callable[[int], float]] = None,
               dynamic_k: bool = True, mesh=None,
               device=None) -> Tuple[int, float]:
    """The best K in [min_k, max_k] by ``method`` ("binary" | "brent")
    and its objective.  With a ``mesh`` (dynamic K only) ``all_feats`` is
    this rank's row shard and ``targets`` / ``mask_lab`` the global
    arrays; every rank returns the same (K, objective)."""
    if objective is not None:
        obj = objective
    elif dynamic_k:
        obj = labelled_acc_objective_dynamic(all_feats, targets, mask_lab,
                                             max_k=max_k, mesh=mesh,
                                             device=device)
    else:
        obj = labelled_acc_objective(all_feats, targets, mask_lab,
                                     device=device)
    if method == "binary":
        return binary_search_k(obj, min_k, max_k, verbose=verbose)
    if method == "brent":
        return scipy_optimise_k(obj, min_k, max_k)
    raise ValueError(f"unknown method {method!r}")


def dummy_objective(max_k: int = 1000, seed: int = 0) -> Callable[[int], float]:
    """Skewnorm fake ACC-vs-K curve for exercising the optimizer without
    running k-means (reference ``DUMMY_ACCS``, ``estimate_k.py:26-38``)."""
    from scipy.stats import skewnorm

    data = skewnorm.rvs(3, loc=50, scale=50, size=1000,
                        random_state=np.random.RandomState(seed)).astype(int)
    params = skewnorm.fit(data, 10, loc=80, scale=40)
    x = np.linspace(0, 255, 500)
    y = skewnorm.pdf(x, *params)
    accs = np.repeat(y, max(int(max_k / 500), 1)) * 100.0

    def obj(k: int) -> float:
        return float(accs[int(np.clip(k, 0, len(accs) - 1))])

    return obj


def main(argv=None):
    """CLI mirroring the reference's ``estimate_k.py`` __main__
    (:245-312): search K over packed features, or over the dummy curve."""
    import argparse

    from scd_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser(description="Estimate number of clusters K")
    p.add_argument("--features", type=str, default=None,
                   help="features_packed.npz with features/targets/mask_lab "
                        "(omit for the dummy-objective self-test)")
    p.add_argument("--min_k", type=int, default=10)
    p.add_argument("--max_k", type=int, default=1000)
    p.add_argument("--search_mode", type=str, default="brent",
                   help="binary | brent")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.features is None:
        obj = dummy_objective(max_k=args.max_k)
        if args.search_mode == "binary":
            best_k, best_acc = binary_search_k(obj, args.min_k, args.max_k,
                                               verbose=True)
        else:
            best_k, best_acc = scipy_optimise_k(obj, args.min_k, args.max_k)
    else:
        with np.load(args.features) as z:
            feats, targets = z["features"], z["targets"]
            mask_lab = z["mask_lab"].astype(bool)
        best_k, best_acc = estimate_k(feats, targets, mask_lab, args.min_k,
                                      args.max_k, method=args.search_mode,
                                      verbose=True, device=dev)
    print(f"Best K: {best_k} (objective {best_acc:.4f})")
    return best_k, best_acc


if __name__ == "__main__":
    main()
