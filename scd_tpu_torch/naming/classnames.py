"""Ground-truth class-name resolution per dataset.

Port of ``scd_tpu/naming/classnames.py`` (reference
``main_unsup.py:397-502``): build ``cidx_to_cname`` — dataset class index
-> vocabulary name.  Names missing from the corpus are repaired in the
reference by matching their text embedding against the vocabulary; that
needs the CLIP text tower, which comes with the encoder slice (ROADMAP
"Slice (d): encoders and vocabulary"), so :func:`_match_missing` raises
when a repair is actually needed.  ImageNet variants never need one: their
names come straight from the taxonomy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _match_missing(miss_names: List[str], candidate_names: List[str],
                   candidate_weights: np.ndarray,
                   encode_text: Optional[Callable],
                   templates: Optional[Sequence[str]],
                   unique: bool = False) -> List[str]:
    """Match names missing from the corpus to their nearest vocabulary
    column by text embedding (reference ``main_unsup.py:402-406``).  Not
    ported yet: needs the text tower of the encoder slice."""
    if not miss_names:
        return []
    raise NotImplementedError(
        f"{len(miss_names)} class name(s) are missing from the corpus "
        f"(e.g. {miss_names[0]!r}); repairing them needs the CLIP text "
        "tower, which the port gains with ROADMAP's encoder slice "
        "(slice (d): encoders and vocabulary)")


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
