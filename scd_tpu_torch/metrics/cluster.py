"""Clustering accuracy metrics.

Semantics mirror the reference exactly (values must match bit-for-bit):

- ``cluster_acc``: contingency + Hungarian, reference
  ``gcd/project_utils/cluster_utils.py:39-62``.
- ``split_cluster_acc_v1/v2/v3``: reference
  ``gcd/project_utils/cluster_and_log_utils.py:6-129``.  v2 (used by both
  mains) runs one global Hungarian over all unlabelled predictions and reads
  Old/New accuracy off the shared assignment.
- ``evaluate_clustering`` / ``purity_score``: reference
  ``gcd/project_utils/cluster_utils.py:22-36, 65-75``.

The K×K Hungarian itself is tiny (K ≤ 1000) and runs on host via
``scipy.optimize.linear_sum_assignment`` — an exact replacement for the
reference's vendored pre-0.21 sklearn Munkres state machine
(``local_utils/linear_assignment.py:29-289``).  The O(N) contingency build is
done with a vectorized bincount (the reference loops in Python,
``cluster_and_log_utils.py:50-51``).  Host numpy code, copied from the JAX
package (``scd_tpu/metrics/cluster.py``) so results are bit-equal.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Hungarian assignment returning [[row, col], ...] sorted by row —
    the same contract as the reference's vendored ``linear_assignment``
    (``local_utils/linear_assignment.py:29-70``)."""
    rows, cols = linear_sum_assignment(cost)
    return np.stack([rows, cols], axis=1)


def contingency_matrix(y_pred: np.ndarray, y_true: np.ndarray,
                       n_rows: Optional[int] = None,
                       n_cols: Optional[int] = None) -> np.ndarray:
    """w[i, j] = #{y_pred == i and y_true == j} via flat bincount."""
    y_pred = np.asarray(y_pred).astype(np.int64)
    y_true = np.asarray(y_true).astype(np.int64)
    D_r = n_rows if n_rows is not None else int(y_pred.max()) + 1
    D_c = n_cols if n_cols is not None else int(y_true.max()) + 1
    flat = y_pred * D_c + y_true
    return np.bincount(flat, minlength=D_r * D_c).reshape(D_r, D_c)


def cluster_acc(y_true: np.ndarray, y_pred: np.ndarray,
                return_ind: bool = False):
    """Hungarian-matched clustering accuracy in [0, 1]."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    assert y_pred.size == y_true.size
    if y_pred.size == 0:
        # Empty subset (e.g. a stratified slice with no Old instances);
        # unreachable in the reference only because its stratified mask was
        # a no-op (k_means_stratified.py:139).
        return (float("nan"), np.zeros((0, 2), int),
                np.zeros((0, 0))) if return_ind else float("nan")
    D = max(int(y_pred.max()), int(y_true.max())) + 1
    w = contingency_matrix(y_pred, y_true, D, D)
    ind = linear_assignment(w.max() - w)
    acc = w[ind[:, 0], ind[:, 1]].sum() * 1.0 / y_pred.size
    if return_ind:
        return acc, ind, w
    return acc


def split_cluster_acc_v1(y_true, y_pred, mask) -> Tuple[float, float, float]:
    """Independent Hungarian per subset (reference v1)."""
    mask = np.asarray(mask).astype(bool)
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    weight = mask.mean()
    old_acc = cluster_acc(y_true[mask], y_pred[mask])
    new_acc = cluster_acc(y_true[~mask], y_pred[~mask])
    if weight == 0.0:  # no Old instances: avoid 0*nan
        return new_acc, old_acc, new_acc
    if weight == 1.0:
        return old_acc, old_acc, new_acc
    total_acc = weight * old_acc + (1 - weight) * new_acc
    return total_acc, old_acc, new_acc


def split_cluster_acc_v2(y_true, y_pred, mask, return_ind_map: bool = False):
    """One global Hungarian; Old/New accuracies from the shared assignment
    (reference v2, ``cluster_and_log_utils.py:29-74``)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    mask = np.asarray(mask).astype(bool)

    old_classes_gt = set(y_true[mask])
    new_classes_gt = set(y_true[~mask])

    assert y_pred.size == y_true.size
    D = max(int(y_pred.max()), int(y_true.max())) + 1
    w = contingency_matrix(y_pred, y_true, D, D)

    ind = linear_assignment(w.max() - w)
    ind_map = {j: i for i, j in ind}
    total_acc = w[ind[:, 0], ind[:, 1]].sum() * 1.0 / y_pred.size

    col_sums = w.sum(axis=0)

    def subset_acc(classes: Iterable[int]) -> float:
        # Empty subset (e.g. fully-unsupervised eval where mask is all-False)
        # -> 0.0; the reference raises ZeroDivisionError here.
        hits = sum(w[ind_map[i], i] for i in classes)
        total = sum(col_sums[i] for i in classes)
        return hits / total if total else 0.0

    old_acc = subset_acc(old_classes_gt)
    new_acc = subset_acc(new_classes_gt)

    if return_ind_map:
        return total_acc, old_acc, new_acc, ind_map
    return total_acc, old_acc, new_acc


def split_cluster_acc_v3(y_true, y_pred, mask) -> Tuple[float, float, float]:
    """Identity map on Old classes, Hungarian only over the New block
    (reference v3, ``cluster_and_log_utils.py:77-129``)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    mask = np.asarray(mask).astype(bool)

    old_classes_gt = set(y_true[mask])
    new_classes_gt = set(y_true[~mask])

    assert y_pred.size == y_true.size
    D = max(int(y_pred.max()), int(y_true.max())) + 1
    w = contingency_matrix(y_pred, y_true, D, D)

    n_old = len(old_classes_gt)
    ind_1 = np.array([[i, i] for i in old_classes_gt], dtype=int).reshape(-1, 2)
    ind_2 = linear_assignment(-w[n_old:, n_old:]) + n_old
    ind = np.concatenate([ind_1, ind_2])
    ind_map = {j: i for i, j in ind}
    total_acc = sum(w[i, j] for i, j in ind) * 1.0 / y_pred.size

    col_sums = w.sum(axis=0)

    def subset_acc(classes: Iterable[int]) -> float:
        hits = sum(w[ind_map[i], i] for i in classes)
        total = sum(col_sums[i] for i in classes)
        return hits / total if total else 0.0

    return total_acc, subset_acc(old_classes_gt), subset_acc(new_classes_gt)


EVAL_FUNCS = {
    "v1": split_cluster_acc_v1,
    "v2": split_cluster_acc_v2,
    "v3": split_cluster_acc_v3,
}


def log_accs_from_preds(y_true, y_pred, mask, eval_funcs, save_name: str,
                        T: Optional[int] = None, writer=None,
                        print_output: bool = False) -> Tuple[float, float, float]:
    """Dispatch over ACC variants; returns the first variant's results
    (reference ``cluster_and_log_utils.py:138-176``)."""
    mask = np.asarray(mask).astype(bool)
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)

    to_return = None
    for i, f_name in enumerate(eval_funcs):
        all_acc, old_acc, new_acc = EVAL_FUNCS[f_name](y_true, y_pred, mask)
        log_name = f"{save_name}_{f_name}"
        if writer is not None:
            writer.add_scalars(log_name, {"Old": old_acc, "New": new_acc,
                                          "All": all_acc}, T)
        if i == 0:
            to_return = (all_acc, old_acc, new_acc)
        if print_output:
            print(f"Epoch {T}, {log_name}: All {all_acc:.4f} | Old {old_acc:.4f} "
                  f"| New {new_acc:.4f}")
    return to_return


def topk_accuracy(logits, targets, ks=(1,)):
    """Top-k accuracies in percent (reference ``clip_lang_util.py:151-154``
    and ``general_utils.py:accuracy``)."""
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    order = np.argsort(-logits, axis=1)
    return [float((order[:, :k] == targets[:, None]).any(axis=1).mean()
                  * 100.0) for k in ks]


def purity_score(y_true, y_pred) -> float:
    """Cluster purity (reference ``cluster_utils.py:65-75``)."""
    w = contingency_matrix(np.asarray(y_pred), np.asarray(y_true))
    return float(np.sum(np.amax(w, axis=1)) / np.sum(w))


def evaluate_clustering(y_true, y_pred) -> Dict[str, float]:
    """ACC + NMI + ARI + purity bundle (reference ``cluster_utils.py:22-36``)."""
    from sklearn.metrics import adjusted_rand_score, normalized_mutual_info_score

    return {
        "acc": float(cluster_acc(y_true, y_pred)),
        "nmi": float(normalized_mutual_info_score(y_true, y_pred)),
        "ari": float(adjusted_rand_score(y_true, y_pred)),
        "purity": purity_score(y_true, y_pred),
    }
