"""ImageNet-21K open-set-recognition split machinery.

Port of ``scd_tpu/data/imagenet_osr.py`` (host numpy code, copied so the
splits are equal).  It ports the semantic-tree preprocessing and OSR class-split selection of the
reference (``gcd/data/imagenet.py:55-199``):

- ``semantic_tree_distances`` — pairwise tree distance between every
  ImageNet-1k wnid and every disjoint ImageNet-21k wnid, where each class
  carries its hypernym path (leaf..root) and the distance is the total
  path length up-and-down through the first common ancestor
  (``preprocess_semantic_tree_v2``, ``imagenet.py:57-160``).
- ``osr_difficulty_splits`` — Easy/Medium/Hard I21K class tiers by total
  semantic distance to I1K (hard = semantically closest,
  ``imagenet.py:142-158``).
- ``get_imagenet_osr_class_splits`` — the consumer entry point
  (``imagenet.py:161-199``): 'random' draws ``num_classes`` disjoint I21K
  classes with ``np.random.seed(0)``; 'Easy'/'Medium'/'Hard' read a
  precomputed tier table.

All filesystem inputs (wnid lists, the semantic tree, precomputed tiers)
are explicit arguments instead of the reference's hardcoded cluster paths
(``imagenet.py:16-19``).  One deliberate deviation: the reference feeds
``list(set(...))`` — a hash-order-dependent sequence — into the seeded
random draw, so its 'random' split is not reproducible across processes;
we sort the disjoint class list first, making the seed-0 draw
deterministic.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


def _pad_to_longest(a: List, b: List) -> Tuple[List, List]:
    """Right-align two hypernym paths by prepending Nones to the shorter
    (reference ``pad_to_longest``, ``imagenet.py:38-52``)."""
    if len(b) > len(a):
        a = [None] * (len(b) - len(a)) + a
    elif len(a) > len(b):
        b = [None] * (len(a) - len(b)) + b
    return a, b


def _tree_distance(tree_a: Sequence[str], tree_b: Sequence[str],
                   total_path: bool = True) -> float:
    """Semantic distance between two classes given their leaf->root
    hypernym paths (``imagenet.py:88-124``)."""
    depth_a, depth_b = len(tree_a), len(tree_b)
    a, b = _pad_to_longest(list(tree_a), list(tree_b))
    eq = [i for i, (x, y) in enumerate(zip(a, b)) if x is not None and x == y]
    if total_path:
        if not eq:
            return depth_a + depth_b + 1
        first = eq[0]
        path_a = first - (max(depth_a, depth_b) - depth_a)
        path_b = first - (max(depth_a, depth_b) - depth_b)
        return path_a + path_b
    if not eq:
        return max(depth_a, depth_b) - 1  # reference: len(padded) - 1
    return eq[0] - 1


def semantic_tree_distances(class_tree_list: Sequence[Sequence[int]],
                            class_list: Sequence[str],
                            i1k_wnids: Sequence[str],
                            i21k_wnids: Sequence[str],
                            total_path: bool = True
                            ) -> Tuple[np.ndarray, List[str]]:
    """Distance matrix [|I1K ∩ tree|, |I21K|] between wnid hypernym paths.

    ``class_tree_list[i]`` is a path of indices into ``class_list`` with the
    class itself first (the reference's tree artifact layout,
    ``imagenet.py:60-68``).  Returns (matrix, the I1K wnid rows actually
    present in the tree).
    """
    tree_by_wnid: Dict[str, List[str]] = {}
    for path in class_tree_list:
        wnids = [class_list[c] for c in path]
        tree_by_wnid[wnids[0]] = wnids

    rows = [w for w in i1k_wnids if w in tree_by_wnid]
    missing = [w for w in i21k_wnids if w not in tree_by_wnid]
    if missing:
        # fail fast with a clear message — the wnid lists and the tree
        # artifact are independent arguments, and a KeyError mid-way
        # through the O(|I1K|*|I21K|) loop names neither the wnid nor the
        # cause
        raise ValueError(
            f"{len(missing)} I21K wnid(s) absent from the semantic tree "
            f"(first: {missing[:3]}); the tree artifact must cover every "
            "I21K class passed in")
    mat = np.zeros((len(rows), len(i21k_wnids)))
    for i, w1 in enumerate(rows):
        t1 = tree_by_wnid[w1]
        for j, w2 in enumerate(i21k_wnids):
            mat[i, j] = _tree_distance(t1, tree_by_wnid[w2],
                                       total_path=total_path)
    return mat, rows


def osr_difficulty_splits(sim_matrix: np.ndarray,
                          i21k_wnids: Sequence[str],
                          tier_size: int = 1000) -> Dict[str, List[str]]:
    """Easy/Medium/Hard I21K tiers by total semantic distance to I1K
    (``imagenet.py:142-158``): hard = smallest total distance (closest),
    easy = largest, medium = a ``tier_size`` window around the median."""
    total = sim_matrix.sum(axis=0)
    order = np.argsort(total, kind="stable")
    mid = (len(order) - 1) // 2
    # clamp the median window: a negative start would silently wrap to a
    # short slice from the tail when len(order) < tier_size
    start = max(mid - tier_size // 2, 0)
    return {
        "hard_i21k_classes": [i21k_wnids[c] for c in order[:tier_size]],
        "medium_i21k_classes": [i21k_wnids[c]
                                for c in order[start:start + tier_size]],
        "easy_i21k_classes": [i21k_wnids[c] for c in order[-tier_size:]],
    }


def get_imagenet_osr_class_splits(
        i21k_class_to_idx: Mapping[str, int],
        i1k_wnids: Sequence[str],
        i21k_wnids: Sequence[str],
        num_classes: int = 1000,
        osr_split: str = "random",
        precomputed: Optional[Mapping[str, Sequence[str]]] = None
) -> List[int]:
    """Class indices (into the I21K dataset) used as open-set classes.

    'random': seed-0 draw of ``num_classes`` from the I21K classes disjoint
    from I1K.  'Easy'/'Medium'/'Hard': look up the precomputed tier table
    (the output of ``osr_difficulty_splits``).
    """
    if osr_split == "random":
        disjoint = sorted(set(i21k_wnids) - set(i1k_wnids))
        chosen = np.random.RandomState(0).choice(disjoint, replace=False,
                                  size=(num_classes,))
        return [i21k_class_to_idx[w] for w in chosen]

    if osr_split in ("Easy", "Medium", "Hard"):
        if precomputed is None:
            raise ValueError(
                f"osr_split={osr_split!r} needs the precomputed tier table "
                "(osr_difficulty_splits output)")
        key = {"Easy": "easy_i21k_classes", "Medium": "medium_i21k_classes",
               "Hard": "hard_i21k_classes"}[osr_split]
        return [i21k_class_to_idx[w] for w in precomputed[key]]

    raise ValueError(f"unknown osr_split {osr_split!r}")
