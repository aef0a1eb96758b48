"""Cluster -> name voting primitives.

Port of ``scd_tpu/naming/vote.py`` (reference ``main_unsup.py:568-614``,
``clip_lang_util.py:156-234``): each image contributes its top-k vocabulary
names; per cluster, a Counter over those name indices selects candidates;
a Hungarian assignment over the cluster x candidate vote matrix picks one
name per cluster.

The N x V top-k runs on the device (``scd_tpu_torch.ops.topk``); the
per-cluster histograms here are host numpy, copied from the JAX package so
the ``Counter.most_common`` order (count descending, ties by first
occurrence in the flattened member sequence) is bit-equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from scd_tpu_torch.metrics.cluster import linear_assignment
from scd_tpu_torch.ops.topk import classify_topk


def topk_names(clip_feats: torch.Tensor, zeroshot_weights: torch.Tensor,
               k: int, scale: float = 100.0,
               apply_softmax: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image top-k vocabulary names on the tensors' device.
    Returns host (idx [N,k] i32, vals [N,k] f32)."""
    vals, idx = classify_topk(clip_feats, zeroshot_weights, k, scale=scale,
                              apply_softmax=apply_softmax)
    return idx.cpu().numpy(), vals.cpu().numpy()


def _most_common(values: np.ndarray) -> List[Tuple[int, int]]:
    """(value, count) pairs ordered like ``collections.Counter.most_common``:
    count desc, ties by first occurrence order."""
    if values.size == 0:
        return []
    uniq, first_pos, counts = np.unique(values, return_index=True,
                                        return_counts=True)
    order = np.lexsort((first_pos, -counts))
    return [(int(uniq[i]), int(counts[i])) for i in order]


def cluster_name_counters(name_idx_topk: np.ndarray, u_preds: np.ndarray,
                          top_k: int) -> Dict[int, List[Tuple[int, int]]]:
    """Per-cluster ordered (name_idx, count) lists from each member's top-k
    names (reference ``main_unsup.py:575-577``).

    One global group-by over (cluster, name) keys instead of a boolean mask
    per cluster: the per-cluster masks are O(K*N*top_k) host work per
    voting round (~2-3 s/round at Herbarium's K=683, N=130k) where the
    flat unique is O(N*top_k log) once (~0.1 s).  Ordering is
    ``Counter.most_common``-exact: count desc, ties by first occurrence in
    the cluster's flattened member sequence — the global row-major flatten
    restricted to one cluster's rows preserves that cluster's own member
    order, so global first-occurrence position ranks ties identically."""
    u_preds = np.asarray(u_preds)
    names = np.ascontiguousarray(name_idx_topk[:, :top_k])
    flat = names.ravel().astype(np.int64)
    if flat.size == 0:
        return {int(c): [] for c in np.unique(u_preds)}
    # shift negative name indices (e.g. -1 pad sentinels) into the radix
    # range — without it a negative entry would floor-divide into the
    # NEIGHBORING cluster's key block and be counted there silently
    off = min(int(flat.min()), 0)
    flat -= off
    v_max = int(flat.max()) + 1
    keys = np.repeat(u_preds.astype(np.int64), names.shape[1]) * v_max + flat
    uniq, first_pos, counts = np.unique(keys, return_index=True,
                                        return_counts=True)
    cl = uniq // v_max
    nm = uniq % v_max + off
    out: Dict[int, List[Tuple[int, int]]] = {}
    # uniq is sorted, so each cluster's entries are one contiguous segment
    bounds = np.searchsorted(cl, np.unique(cl), side="left").tolist()
    bounds.append(len(cl))
    for s, e in zip(bounds[:-1], bounds[1:]):
        order = np.lexsort((first_pos[s:e], -counts[s:e]))
        out[int(cl[s])] = [(int(nm[s + i]), int(counts[s + i]))
                           for i in order]
    return out


def vote_candidates(counters: Dict[int, List[Tuple[int, int]]],
                    num_common_vote: int) -> List[int]:
    """Union of each cluster's top ``num_common_vote`` candidate name indices
    (reference ``main_unsup.py:579-586``), deduplicated, sorted."""
    voted = set()
    for entries in counters.values():
        for name_idx, _cnt in entries[:num_common_vote]:
            voted.add(name_idx)
    return sorted(voted)


def assign_name(unique_name_idx: Sequence[int],
                cluster_to_counter: Dict[int, List[Tuple[int, int]]],
                num_common: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian cluster<->name matching over the vote matrix
    (reference ``clip_lang_util.py:156-180``).

    Returns (ind [[cluster_row, name_col], ...], w vote matrix).
    """
    unameidx_to_newidx = {u: n for n, u in enumerate(unique_name_idx)}
    clusters = list(cluster_to_counter.keys())
    D = max(len(unique_name_idx), len(clusters))
    w = np.zeros((D, D), dtype=np.int64)
    for i, c in enumerate(clusters):
        for name_idx, cnt in cluster_to_counter[c][:num_common]:
            # entries past the candidate pool occur when num_common >
            # num_common_vote (both are independent config knobs): votes
            # for names outside the pool simply don't count, rather than
            # KeyError-ing the round
            col = unameidx_to_newidx.get(name_idx)
            if col is not None:
                w[i, col] += cnt
    ind = linear_assignment(w.max() - w)
    return ind, w


def assign_name_on_leftover(unique_name_idx: Sequence[int],
                            cluster_to_counter: Dict[int, List[Tuple[int, int]]],
                            voted_unique_name_idx: Sequence[int],
                            num_common: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Variant excluding already-voted names from the vote matrix
    (reference ``clip_lang_util.py:182-206``)."""
    excluded = set(voted_unique_name_idx)
    unameidx_to_newidx = {u: n for n, u in enumerate(unique_name_idx)}
    clusters = list(cluster_to_counter.keys())
    D = max(len(unique_name_idx), len(clusters))
    w = np.zeros((D, D), dtype=np.int64)
    for i, c in enumerate(clusters):
        for name_idx, cnt in cluster_to_counter[c][:num_common]:
            if name_idx in excluded:
                continue
            w[i, unameidx_to_newidx[name_idx]] += cnt
    ind = linear_assignment(w.max() - w)
    return ind, w


def assign_name_logits(unique_name_idx: Sequence[int],
                       cluster_to_logit_counter: Dict[int, List[Tuple[int, float]]],
                       num_common: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Logit-weighted vote variant (reference ``clip_lang_util.py:208-234``):
    counter values are summed softmax scores rather than counts.

    Bit-parity quirk: the reference accumulates the float scores into an
    INT vote matrix (``clip_lang_util.py:224`` — ``np.zeros(..., dtype=int)``),
    truncating each cluster's summed score toward zero.  At pipeline scale
    the sums span tens-to-hundreds (softmax mass over a cluster's members)
    so the truncation is sub-1% noise, but it is observable — reproduced
    here exactly (checked against the reference in
    ``tests/test_reference_parity.py``)."""
    unameidx_to_newidx = {u: n for n, u in enumerate(unique_name_idx)}
    clusters = list(cluster_to_logit_counter.keys())
    D = max(len(unique_name_idx), len(clusters))
    w = np.zeros((D, D), dtype=np.int64)
    for i, c in enumerate(clusters):
        entries = sorted(cluster_to_logit_counter[c], key=lambda kv: kv[1],
                         reverse=True)[:num_common]
        for name_idx, val in entries:
            # each candidate name is unique within a cluster, so the +=
            # runs once per cell: int(trunc(val)), the reference cast
            w[i, unameidx_to_newidx[name_idx]] += int(val)
    ind = linear_assignment(w.max() - w)
    return ind, w


def cluster_logit_counters(name_idx_topk: np.ndarray, name_val_topk: np.ndarray,
                           u_preds: np.ndarray, top_k: int
                           ) -> Dict[int, List[Tuple[int, float]]]:
    """Per-cluster summed top-k scores per name (for ``assign_name_logits``).

    Entries are emitted in FIRST-OCCURRENCE order within the cluster's
    flattened member sequence — the insertion order a ``collections.Counter``
    built by iterating members would have.  ``assign_name_logits``'s stable
    value-descending sort then breaks exact score ties the same way the
    reference's ``sorted(ct.items(), ...)`` does (ties are reachable: with
    ``apply_softmax=True`` and scale 100 a dominant name's per-image score
    saturates to exactly 1.0 in float32)."""
    u_preds = np.asarray(u_preds)
    out: Dict[int, List[Tuple[int, float]]] = {}
    for c in np.unique(u_preds):
        sel = u_preds == c
        idx = name_idx_topk[sel, :top_k].ravel()
        val = name_val_topk[sel, :top_k].ravel()
        uniq, first_pos, inv = np.unique(idx, return_index=True,
                                         return_inverse=True)
        sums = np.bincount(inv, weights=val)
        order = np.argsort(first_pos, kind="stable")
        out[int(c)] = [(int(uniq[i]), float(sums[i])) for i in order]
    return out
