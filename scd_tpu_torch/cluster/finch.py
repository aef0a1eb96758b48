"""FINCH: parameter-free first-neighbor agglomerative clustering.

Port of ``scd_tpu/cluster/finch.py`` (reference ``local_utils/finch.py``,
Sarfraz et al., CVPR 2019).  Semantics preserved: link i~j when nn(i)=j,
nn(j)=i, or nn(i)=nn(j) (the ``(A+I)(A+I)^T`` clustering equation); weak
connected components; recursive merging over cluster means; ``min_sim``
pruning of long links at deeper levels; optional refinement to an exact
requested cluster count by one-merge-at-a-time agglomeration.

The only O(N^2) work, the first-neighbor search, runs blockwise on the
features' device (no N x N matrix anywhere); the component and merge
bookkeeping is O(N) host numpy on the edge list, copied from the JAX
package so the partitions are the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from scd_tpu_torch.cluster.kmeans import _device_f32
from scd_tpu_torch.ops.distance import pairwise_sqdist


def first_neighbors(x: torch.Tensor, distance: str = "cosine",
                    block: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise 1-NN on ``x``'s device.  Returns host (nn_idx [N] int64,
    nn_dist [N] f32).  Cosine is the f32 product of the normalized rows
    (TF32 off, as the JAX package's ``Precision.HIGHEST``); l2 the square
    root of ``pairwise_sqdist``.  The self-distance is masked with inf (a
    finite sentinel mislabels points whose true 1-NN distance exceeds
    it); ties go to the lowest index."""
    x = x.float()
    n = x.shape[0]
    if distance == "cosine":
        src = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    elif distance in ("euclidean", "l2"):
        src = x
    else:
        raise ValueError(f"unsupported distance {distance!r}")
    nn = np.empty(n, np.int64)
    nd = np.empty(n, np.float32)
    for start in range(0, n, block):
        rows = src[start:start + block]
        if distance == "cosine":
            d = 1.0 - torch.matmul(rows, src.t())  # [B, N]
        else:
            d = torch.sqrt(pairwise_sqdist(rows, src))
        b = rows.shape[0]
        d[torch.arange(b, device=d.device),
          torch.arange(start, start + b, device=d.device)] = float("inf")
        dist, idx = d.min(dim=1)
        nn[start:start + b] = idx.cpu().numpy()
        nd[start:start + b] = dist.cpu().numpy()
    return nn, nd


def _pair_dist(x: np.ndarray, i: np.ndarray, j: np.ndarray,
               distance: str) -> np.ndarray:
    a, b = x[i], x[j]
    if distance == "cosine":
        na = np.linalg.norm(a, axis=1)
        nb = np.linalg.norm(b, axis=1)
        return 1.0 - np.sum(a * b, axis=1) / np.maximum(na * nb, 1e-12)
    return np.linalg.norm(a - b, axis=1)


def _edges_from_nn(nn: np.ndarray,
                   clique_cap: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """All links of the clustering equation: (i, nn_i) plus the full clique
    over each same-neighbor group {i : nn(i) == v} — exactly what the
    reference's ``(A+I)(A+I)^T`` produces (``finch.py:20-45``).  The clique
    matters under ``min_sim`` pruning: a chain's two short hops can both be
    pruned while the direct pair survives.  Groups larger than
    ``clique_cap`` (rare hub points) fall back to chain links to bound the
    O(g²) edge count."""
    n = len(nn)
    e_i = [np.arange(n)]
    e_j = [nn]
    order = np.argsort(nn, kind="stable")
    sorted_nn = nn[order]
    boundaries = np.flatnonzero(np.diff(sorted_nn)) + 1
    starts = np.concatenate([[0], boundaries])
    stops = np.concatenate([boundaries, [len(nn)]])
    for a, b in zip(starts, stops):
        g = b - a
        if g < 2:
            continue
        members = order[a:b]
        if g <= clique_cap:
            ii, jj = np.triu_indices(g, k=1)
            e_i.append(members[ii])
            e_j.append(members[jj])
        else:  # hub fallback: consecutive chain keeps memory bounded
            e_i.append(members[:-1])
            e_j.append(members[1:])
    return np.concatenate(e_i), np.concatenate(e_j)


def _components(n: int, e_i: np.ndarray, e_j: np.ndarray
                ) -> Tuple[np.ndarray, int]:
    a = sp.csr_matrix((np.ones(len(e_i), np.float32), (e_i, e_j)), shape=(n, n))
    num, labels = sp.csgraph.connected_components(a, directed=True,
                                                  connection="weak",
                                                  return_labels=True)
    return labels, num


def _group_means(data: np.ndarray, labels: np.ndarray) -> np.ndarray:
    k = labels.max() + 1
    sums = np.zeros((k, data.shape[1]), np.float64)
    np.add.at(sums, labels, data)
    counts = np.bincount(labels, minlength=k)
    return (sums / counts[:, None]).astype(np.float32)


def finch(data, req_clust: Optional[int] = None,
          distance: str = "cosine", verbose: bool = False, device=None
          ) -> Tuple[np.ndarray, List[int], Optional[np.ndarray]]:
    """Returns (c [N, P] partitions, num_clust per partition, req_c).
    ``data`` is numpy or a tensor; the neighbor searches run on ``device``
    (as the k-means fitters decide it: a tensor stays where it is, numpy
    goes to the card, ``device="cpu"`` runs on the CPU)."""
    x = _device_f32(data, device)
    dev = x.device
    data = x.cpu().numpy()
    n = len(data)

    nn, _nd = first_neighbors(x, distance)
    e_i, e_j = _edges_from_nn(nn)
    group, num = _components(n, e_i, e_j)
    c = group[:, None]
    mat = _group_means(data, group)
    # prune threshold: the longest link accepted at the first level
    min_sim = float(_pair_dist(data, e_i, e_j, distance).max())
    num_clust = [num]

    if verbose:
        print(f"Partition 0: {num} clusters")

    c_ = group
    while True:
        nn, _ = first_neighbors(torch.from_numpy(mat).to(dev), distance)
        e_i, e_j = _edges_from_nn(nn)
        d = _pair_dist(mat, e_i, e_j, distance)
        keep = d <= min_sim
        labels, num_curr = _components(len(mat), e_i[keep], e_j[keep])
        c_ = labels[c_]
        mat = _group_means(data, c_)

        gain = num_clust[-1] - num_curr
        if num_curr == 1 or gain < 1:
            break
        num_clust.append(num_curr)
        c = np.column_stack([c, c_])
        if verbose:
            print(f"Partition {c.shape[1] - 1}: {num_curr} clusters")

    req_c = None
    if req_clust is not None:
        if req_clust in num_clust:
            req_c = c[:, num_clust.index(req_clust)]
        else:
            ok = [i for i, v in enumerate(num_clust) if v >= req_clust]
            if not ok:
                req_c = c[:, 0]
            else:
                req_c = _merge_to_k(c[:, ok[-1]], data, req_clust, distance)
    return c, num_clust, req_c


def _merge_to_k(labels: np.ndarray, data: np.ndarray, k: int,
                distance: str) -> np.ndarray:
    """One merge per step: join the closest pair of cluster means
    (reference ``req_numclust``/``update_adj``, ``finch.py:83-103``)."""
    _, labels = np.unique(labels, return_inverse=True)
    while labels.max() + 1 > k:
        means = _group_means(data, labels)
        m = len(means)
        if distance == "cosine":
            norm = means / np.maximum(
                np.linalg.norm(means, axis=1, keepdims=True), 1e-12)
            d = 1.0 - norm @ norm.T
        else:
            d = np.linalg.norm(means[:, None] - means[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        i, j = np.unravel_index(np.argmin(d), d.shape)
        keep, merge = min(i, j), max(i, j)
        labels = np.where(labels == merge, keep, labels)
        _, labels = np.unique(labels, return_inverse=True)
    return labels


def finch_fit(data, req_clust: Optional[int] = None,
              distance: str = "cosine", device=None) -> np.ndarray:
    """Convenience: labels at the requested K (or the last partition).
    ``device`` as in :func:`finch`."""
    c, num_clust, req_c = finch(data, req_clust=req_clust, distance=distance,
                                device=device)
    if req_c is not None:
        return req_c.astype(np.int64)
    return c[:, -1].astype(np.int64)
