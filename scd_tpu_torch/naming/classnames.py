"""Ground-truth class-name resolution per dataset.

Port of ``scd_tpu/naming/classnames.py`` (reference
``main_unsup.py:397-502``): build ``cidx_to_cname`` — dataset class index
-> vocabulary name.  Names missing from the corpus are repaired in the
reference by matching their prompt-ensembled text embedding against the
vocabulary columns (:func:`_match_missing`, through the CLIP text tower).
ImageNet variants never need one: their names come straight from the
taxonomy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _match_missing(miss_names: List[str], candidate_names: List[str],
                   candidate_weights,
                   encode_text: Optional[Callable],
                   templates: Optional[Sequence[str]],
                   unique: bool = False) -> List[str]:
    """Embed missing names (prompt-ensembled) and match each to its nearest
    candidate column (reference ``main_unsup.py:402-406``); ``unique`` takes
    the best not-yet-used candidate column (sdogs/wikidog branch,
    ``main_unsup.py:461-469``).  ``candidate_weights`` [D, C] may be a
    numpy array or a tensor."""
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights

    if not miss_names:
        return []
    if isinstance(candidate_weights, torch.Tensor):
        candidate_weights = candidate_weights.detach().cpu().numpy()
    w_miss = build_zeroshot_weights(encode_text, miss_names, templates)  # [D,M]
    logits = w_miss.T @ candidate_weights  # [M, C]
    if not unique:
        top1 = logits.argmax(axis=1)
        return [candidate_names[i] for i in top1]
    order = np.argsort(-logits, axis=1)
    matched: List[str] = []
    used = set()
    for i in range(len(miss_names)):
        # uniqueness tracks candidate columns, not name strings
        for j in range(order.shape[1]):
            col = int(order[i, j])
            if col not in used:
                used.add(col)
                matched.append(candidate_names[col])
                break
        else:
            # more missing names than candidates: the best match
            matched.append(candidate_names[int(order[i, 0])])
    return matched


def remap_cidx_to_cname(cidx_to_cname: Dict[int, str],
                        train_classes: Sequence[int],
                        unlabeled_classes: Sequence[int]) -> Dict[int, str]:
    """Re-key a name map from the dataset's ORIGINAL class ids to the
    pipeline's remapped ids (``make_target_transform``: labelled classes
    first, then unlabelled).  Identity when the splits are contiguous
    ranges (cifar/imagenet defaults); load-bearing for the SSB splits,
    whose known-class ids are scattered.  Keys are inserted in remapped-id
    order so ``list(values())`` indexes by remapped id."""
    from scd_tpu_torch.data.core import make_target_transform

    tt = make_target_transform(train_classes, unlabeled_classes)
    known = set(int(c) for c in train_classes) | set(
        int(c) for c in unlabeled_classes)
    remapped = {tt(int(c)): n for c, n in cidx_to_cname.items()
                if int(c) in known}
    return {k: remapped[k] for k in sorted(remapped)}


def resolve_class_names(dataset_name: str,
                        extras: Dict,
                        nouns: List[str],
                        zeroshot_weights,
                        encode_text: Optional[Callable] = None,
                        templates: Optional[Sequence[str]] = None,
                        wnid_to_name: Optional[Dict[str, str]] = None,
                        corpus: str = "wordnet") -> Dict[int, str]:
    """Build cidx_to_cname keyed on the dataset's ORIGINAL class ids.
    Pipelines consuming remapped targets must re-key through
    :func:`remap_cidx_to_cname`.  ``zeroshot_weights`` may be a numpy
    array or a tensor; it is only read when a name needs repair."""
    noun_set = set(nouns)

    def repaired(class_to_idx: Dict[str, int],
                 candidate_names: List[str],
                 candidate_weights,
                 unique: bool = False) -> Dict[int, str]:
        original = list(class_to_idx.keys())
        miss = [n for n in original if n not in noun_set]
        matched = _match_missing(miss, candidate_names, candidate_weights,
                                 encode_text, templates, unique=unique)
        out = {}
        for name, idx in class_to_idx.items():
            out[idx] = matched[miss.index(name)] if name in miss else name
        return out

    if dataset_name == "synthetic":
        names = extras["class_names"]
        return {i: n for i, n in enumerate(names)}

    if dataset_name in ("cifar10", "cifar100", "aircraft"):
        class_to_idx = extras["class_to_idx"]
        class_to_idx = {n.lower().replace("-", "_"): i
                        for n, i in class_to_idx.items()}
        return repaired(class_to_idx, nouns, zeroshot_weights)

    if dataset_name in ("imagenet_100", "imagenet_1000", "imagenet_127"):
        # ImageFolder class order == sorted wnid dirs; remapped ids follow
        # class_map for the 100-class subset
        wnids: List[str] = extras["classes"]  # sorted wnid dir names
        if "class_map" in extras:  # idx1000 -> idx100
            cidx_to_wnid = {v: wnids[k] if isinstance(k, int) else wnids[int(k)]
                            for k, v in extras["class_map"].items()}
        else:
            cidx_to_wnid = dict(enumerate(wnids))
        return {c: wnid_to_name[w].lower().replace("-", "_")
                for c, w in cidx_to_wnid.items()}

    if dataset_name == "sdogs":
        wnid_names = sorted(extras["breeds"])  # "nXXXXXXXX-Breed_name"
        class_to_idx = {}
        cidx_to_cname = {}
        for i, w_n in enumerate(wnid_names):
            name = w_n[10:].lower().replace("-", "_")
            cidx_to_cname[i] = name
            class_to_idx[name] = i
        if corpus == "wikidog":
            miss = [n for n in class_to_idx if n not in noun_set]
            truncated_idx = [i for i, n in enumerate(nouns)
                             if n not in class_to_idx]
            trunc_names = [nouns[i] for i in truncated_idx]
            matched = _match_missing(miss, trunc_names, None, encode_text,
                                     templates, unique=True)
            for name, idx in class_to_idx.items():
                if name in miss:
                    cidx_to_cname[idx] = matched[miss.index(name)]
        return cidx_to_cname

    if dataset_name == "cub":
        classnames = extras["classnames"]  # "NNN.Name"
        class_to_idx = {n.split(".")[1].lower().replace("-", "_"):
                        int(n.split(".")[0]) - 1 for n in classnames}
        original = set(class_to_idx)
        trunc_names = [n for n in nouns if n not in original]
        miss = [n for n in class_to_idx if n not in noun_set]
        matched = _match_missing(miss, trunc_names, None, encode_text,
                                 templates)
        out = {}
        for name, idx in class_to_idx.items():
            out[idx] = matched[miss.index(name)] if name in miss else name
        return out

    raise NotImplementedError(f"class-name resolution for {dataset_name!r}")
