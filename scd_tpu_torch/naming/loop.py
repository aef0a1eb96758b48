"""Iterative CLIP vocabulary-voting loops (unsupervised and partially
supervised) and their textual enhancement rounds.

Port of ``scd_tpu/naming/loop.py`` (reference ``main_unsup.py:568-641``,
``main_ptsup.py:629-705``).  Each round:

1. per-cluster histograms over the members' (fixed) top-k full-vocabulary
   name indices;
2. candidate pool = union of each cluster's ``num_common_vote`` most common
   names (ptsup: the labelled classes' names are pruned from the
   histograms, ``main_ptsup.py:638``);
3. Hungarian assignment over the cluster x candidate vote matrix picks one
   candidate per cluster; unsup keeps the resulting name list
   **positional** (row order), ptsup rebuilds ``cand_names = sorted(voted
   ∪ labelled)`` (``main_ptsup.py:657-659``);
4. every unlabelled image is re-classified against only the selected names'
   text embeddings — one [N, D]·[D, C] matmul on the features' device
   (``main_unsup.py:601-614``); the argmaxes become the new memberships;
5. repeat until the voted name set reaches a fixpoint.

Host work is only set algebra and a tiny Hungarian.  The feature and
weight tensors stay on their device across rounds; only the [N] argmax
comes back each round.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from scd_tpu_torch.core.config import NamingConfig
from scd_tpu_torch.naming.vote import assign_name, cluster_name_counters


@dataclasses.dataclass
class VotingResult:
    cand_names: List[str]  # candidate index -> name (u_preds index into this)
    u_preds: np.ndarray  # final per-image candidate assignment
    n_iters: int
    history: List[dict]  # per-iteration diagnostics from the callback
    lab_class_index: Optional[List[int]] = None  # ptsup: candidate cols of labelled names


def gather_weight_columns(weights: torch.Tensor,
                          cols_idx: Sequence[int]) -> torch.Tensor:
    """[D, C] candidate columns of a [D, V] weight tensor, gathered on its
    own device (only the [C] index vector moves)."""
    idx = torch.as_tensor(np.asarray(cols_idx, np.int64),
                          device=weights.device)
    return weights.index_select(1, idx).float()


def _reclassify(clip_u_feats: torch.Tensor, zeroshot_weights: torch.Tensor,
                name_cols: Sequence[int], scale: float) -> np.ndarray:
    """argmax over the selected name columns (reference
    ``main_unsup.py:601-614``).  The product stays ``torch.matmul`` in f32,
    as the JAX package leaves it to XLA; ties go to the first column."""
    w_sel = gather_weight_columns(zeroshot_weights, name_cols)
    logits = scale * torch.matmul(clip_u_feats, w_sel)
    return logits.argmax(dim=1).cpu().numpy()


def voting_loop(nouns: Sequence[str],
                name_idx_topk: np.ndarray,
                clip_u_feats: torch.Tensor,
                zeroshot_weights: torch.Tensor,
                u_preds_init: np.ndarray,
                n_clusters: int,
                cfg: NamingConfig,
                metrics_cb: Optional[Callable[[int, np.ndarray, List[str]], dict]] = None,
                ) -> VotingResult:
    """Unsupervised voting loop (``main_unsup.py:568-641``).

    ``clip_u_feats`` [N, D] and ``zeroshot_weights`` [D, V] are f32 tensors
    on one device.  ``cand_names`` is positional: entry ``i`` is the name
    the Hungarian gave the ``i``-th cluster id present in ``u_preds``
    (sorted), truncated to ``n_clusters`` rows, as the reference builds it.
    """
    noun_to_col = {n: i for i, n in enumerate(nouns)}
    u_preds = np.asarray(u_preds_init).copy()
    cur_voted = [0]
    prev_voted = [1]
    history: List[dict] = []
    it = 0
    cand_names: List[str] = []

    while set(cur_voted) != set(prev_voted) and it < cfg.max_vote_iters:
        it += 1
        counters = cluster_name_counters(name_idx_topk, u_preds, cfg.topk)

        voted_idx = sorted({n for e in counters.values()
                            for n, _ in e[:cfg.num_common_vote]})
        ind, _w = assign_name(voted_idx, counters,
                              num_common=cfg.num_common_linear)

        prev_voted = cur_voted
        # positional: row i of ind is the i-th cluster in sorted-cluster order;
        # rows past len(voted_idx) would KeyError in the reference — skip
        # them (loudly: dropped rows break the one-name-per-cluster contract)
        cur_voted = [nouns[voted_idx[col]] for _row, col in ind[:n_clusters]
                     if col < len(voted_idx)]
        n_dropped = min(n_clusters, len(ind)) - len(cur_voted)
        if n_dropped:
            print(f"[voting] {n_dropped} cluster(s) got no candidate name "
                  f"this round (candidate pool {len(voted_idx)} < clusters)")
        cand_names = list(cur_voted)

        u_preds = _reclassify(clip_u_feats, zeroshot_weights,
                              [noun_to_col[n] for n in cand_names],
                              cfg.logit_scale)
        if metrics_cb is not None:
            history.append(metrics_cb(it, u_preds, cand_names) or {})

    return VotingResult(cand_names=cand_names, u_preds=u_preds,
                        n_iters=it, history=history)


def textual_enhancement(clip_u_feats: torch.Tensor,
                        zeroshot_weights: torch.Tensor,
                        u_preds: np.ndarray,
                        name_cols: Sequence[int],
                        alpha: float = 0.5) -> torch.Tensor:
    """Text-enhanced image features ('TE' in the reference's result tables):
    each image's visual embedding mixed with the text embedding of its
    currently assigned name, re-normalized.  Returns an [N, D] tensor on
    the features' device."""
    w_sel = gather_weight_columns(zeroshot_weights, name_cols)
    preds = torch.as_tensor(np.asarray(u_preds, np.int64),
                            device=clip_u_feats.device)
    t = w_sel.t().index_select(0, preds)  # [N, D] text embedding of the name
    mixed = clip_u_feats.float() + alpha * t
    return mixed / mixed.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def voting_loop_te(nouns: Sequence[str],
                   name_idx_topk: np.ndarray,
                   clip_u_feats: torch.Tensor,
                   zeroshot_weights: torch.Tensor,
                   result: VotingResult,
                   n_clusters: int,
                   cfg: NamingConfig,
                   alpha: float = 0.5,
                   metrics_cb=None) -> VotingResult:
    """One textual-enhancement round: enhance features with the converged
    assignment's name embeddings, then re-run the voting loop from the
    enhanced re-classification ('w/TE' rows of the reference tables)."""
    noun_to_col = {n: i for i, n in enumerate(nouns)}
    cols = [noun_to_col[n] for n in result.cand_names]
    enhanced = textual_enhancement(clip_u_feats, zeroshot_weights,
                                   result.u_preds, cols, alpha=alpha)
    return voting_loop(nouns, name_idx_topk, enhanced, zeroshot_weights,
                       result.u_preds, n_clusters, cfg,
                       metrics_cb=metrics_cb)


def voting_loop_ptsup_te(nouns: Sequence[str],
                         name_idx_topk: np.ndarray,
                         clip_u_feats: torch.Tensor,
                         zeroshot_weights: torch.Tensor,
                         result: VotingResult,
                         lab_names: Sequence[str],
                         n_clusters: int,
                         cfg: NamingConfig,
                         alpha: float = 0.5,
                         metrics_cb=None) -> VotingResult:
    """Textual-enhancement round for the partially supervised loop: enhance
    the visual features with the converged assignment's name embeddings and
    re-run ``voting_loop_ptsup`` from that assignment (labelled names stay
    pinned).  Gives the ptsup 'w/TE' rows of the reference tables."""
    noun_to_col = {n: i for i, n in enumerate(nouns)}
    cols = [noun_to_col[n] for n in result.cand_names]
    enhanced = textual_enhancement(clip_u_feats, zeroshot_weights,
                                   result.u_preds, cols, alpha=alpha)
    lab_set = set(lab_names)
    unlab_cluster_idx = [i for i, n in enumerate(result.cand_names)
                         if n not in lab_set]
    return voting_loop_ptsup(nouns, name_idx_topk, enhanced,
                             zeroshot_weights, result.u_preds,
                             unlab_cluster_idx, lab_names, n_clusters, cfg,
                             metrics_cb=metrics_cb)


def voting_loop_ptsup(nouns: Sequence[str],
                      name_idx_topk: np.ndarray,
                      clip_u_feats: torch.Tensor,
                      zeroshot_weights: torch.Tensor,
                      u_preds_init: np.ndarray,
                      unlab_cluster_idx_init: Sequence[int],
                      lab_names: Sequence[str],
                      n_clusters: int,
                      cfg: NamingConfig,
                      metrics_cb: Optional[Callable[[int, np.ndarray, List[str]], dict]] = None,
                      ) -> VotingResult:
    """Partially-supervised voting loop (``main_ptsup.py:629-705``).

    Labelled classes pin their ground-truth names; only unlabelled clusters
    vote, with labelled names pruned from the histograms.  After each round
    ``cand_names = sorted(voted ∪ labelled)`` and the cluster/known index
    sets are recomputed against the new candidate list.
    """
    noun_to_col = {n: i for i, n in enumerate(nouns)}
    lab_names = list(lab_names)
    num_unlab_classes = n_clusters - len(lab_names)

    u_preds = np.asarray(u_preds_init).copy()
    lab_set = set(lab_names)
    known_name_idx = {noun_to_col[n] for n in lab_names}
    unlab_cluster_set = set(unlab_cluster_idx_init)
    cur_voted = [0]
    prev_voted = [1]
    history: List[dict] = []
    it = 0
    cand_names: List[str] = []
    lab_class_index: List[int] = []

    while set(cur_voted) != set(prev_voted) and it < cfg.max_vote_iters:
        it += 1
        counters = cluster_name_counters(name_idx_topk, u_preds, cfg.topk)
        counters = {c: [(n, v) for n, v in e if n not in known_name_idx]
                    for c, e in counters.items() if c in unlab_cluster_set}
        if not counters:
            # every image reclassified into a labelled name (or every
            # unlabelled histogram was pruned away): nothing left to vote
            # on, so stop with the labelled names as the candidate set (the
            # reference would crash on a zero-size vote matrix).  On a
            # first-iteration break u_preds are still the caller's cluster
            # ids: reclassify against the returned candidate list and
            # report the labelled columns.
            if not cand_names:
                cand_names = sorted(lab_names)
                u_preds = _reclassify(clip_u_feats, zeroshot_weights,
                                      [noun_to_col[n] for n in cand_names],
                                      cfg.logit_scale)
                name_pos = {n: i for i, n in enumerate(cand_names)}
                lab_class_index = [name_pos[n] for n in lab_names]
            break

        voted_idx = sorted({n for e in counters.values()
                            for n, _ in e[:cfg.num_common_vote]})
        ind, _w = assign_name(voted_idx, counters,
                              num_common=cfg.num_common_linear)

        prev_voted = cur_voted
        cur_voted = [nouns[voted_idx[col]] for _row, col in ind[:num_unlab_classes]
                     if col < len(voted_idx)]

        cand_names = sorted(set(cur_voted) | lab_set)
        # one dict inversion keeps the bookkeeping O(K) per round
        name_pos = {n: i for i, n in enumerate(cand_names)}
        lab_class_index = [name_pos[n] for n in lab_names]
        unlab_cluster_set = {name_pos[n] for n in cand_names
                             if n not in lab_set}

        u_preds = _reclassify(clip_u_feats, zeroshot_weights,
                              [noun_to_col[n] for n in cand_names],
                              cfg.logit_scale)
        if metrics_cb is not None:
            history.append(metrics_cb(it, u_preds, cand_names) or {})

    return VotingResult(cand_names=cand_names, u_preds=u_preds,
                        n_iters=it, history=history,
                        lab_class_index=lab_class_index)
