"""Semantic accuracy metrics (sACC / Soft-sACC / name-set IoU).

Reference semantics:

- ``evaluate_semantic_acc`` — exact string match between the name assigned to
  an instance's predicted cluster and its ground-truth class name; returns
  (per-class average, overall) (``main_unsup.py:149-167``).
- ``evaluate_soft_semantic_acc`` — WordNet Leacock–Chodorow similarity, maxed
  over all synset pairs of (pred, target) names, normalized by the batch max
  (``main_unsup.py:170-199``).  The similarity is injected as a callable so
  the taxonomy backend (nltk WordNet, our WNDB reader, or a synthetic
  fixture) is pluggable.  ``soft_semantic_acc_from_table`` is the same
  metric gathered from a precomputed similarity table.
- ``name_set_iou`` — IoU of predicted vs GT name sets (``main_unsup.py:645-647``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np


def evaluate_semantic_acc(u_targets: Sequence[int],
                          cidx_to_cname: Mapping[int, str],
                          u_preds: Sequence[int],
                          cand_names: Sequence[str]) -> Tuple[float, float]:
    """Exact-match semantic accuracy. Returns (avg over classes, overall)."""
    per_class: Dict[str, list] = defaultdict(list)
    matched_all = []
    for u_target, u_pred in zip(u_targets, u_preds):
        tname = cidx_to_cname[int(u_target)]
        hit = 1 if tname == cand_names[int(u_pred)] else 0
        per_class[tname].append(hit)
        matched_all.append(hit)

    acc_all = sum(matched_all) / float(len(matched_all))
    acc_avg = sum(sum(v) / float(len(v)) for v in per_class.values()) / len(per_class)
    return acc_avg, acc_all


def evaluate_soft_semantic_acc(u_targets: Sequence[int],
                               cidx_to_cname: Mapping[int, str],
                               u_preds: Sequence[int],
                               cand_names: Sequence[str],
                               name_similarity: Callable[[str, str], float]) -> float:
    """Similarity-weighted semantic accuracy, normalized by the batch max.

    ``name_similarity(pred, target)`` must reproduce the reference's
    max-over-synset-pairs lch similarity (``main_unsup.py:170-188``).
    """
    sims = np.array([
        name_similarity(cand_names[int(p)], cidx_to_cname[int(t)])
        for t, p in zip(u_targets, u_preds)
    ], dtype=np.float64)
    sims = sims / max(float(sims.max()), 1e-12)
    return float(sims.sum() / len(sims))


def soft_semantic_acc_from_table(u_targets: np.ndarray,
                                 u_preds: np.ndarray,
                                 target_name_idx: np.ndarray,
                                 pred_name_idx: np.ndarray,
                                 sim_table: np.ndarray) -> float:
    """Vectorized Soft-sACC: ``sim_table[pred_name, target_name]`` gathered per
    instance.  ``target_name_idx[c]`` maps a GT class index to a row of the
    precomputed similarity table; ``pred_name_idx[k]`` maps a cluster/candidate
    index likewise."""
    sims = sim_table[pred_name_idx[np.asarray(u_preds, dtype=np.int64)],
                     target_name_idx[np.asarray(u_targets, dtype=np.int64)]]
    sims = sims / max(float(sims.max()), 1e-12)
    return float(sims.mean())


def name_set_iou(cand_names: Sequence[str], gt_names: Sequence[str]) -> float:
    inter = set(cand_names) & set(gt_names)
    union = set(cand_names) | set(gt_names)
    return len(inter) * 1.0 / len(union)
