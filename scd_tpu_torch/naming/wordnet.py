"""Taxonomy backend for name dictionaries and Leacock–Chodorow similarity.

The reference leans on nltk's WordNet corpus for three things
(``local_utils/clip_lang_util.py:113-137``, ``main_unsup.py:170-199``):

1. the noun vocabulary (first lemma name per synset, lowercased, ``-``→``_``),
2. ``name -> [synset]`` multi-mapping for soft-sACC,
3. ``lch_similarity`` between synsets.

This module reimplements those on top of a pluggable taxonomy store so the
framework works without nltk's downloaded corpus:

- ``Taxonomy.from_wndb(dir)`` parses the standard WNDB database format
  (``index.noun`` / ``data.noun``) directly;
- ``Taxonomy.from_nltk()`` wraps an installed nltk corpus when available.

lch matches nltk exactly (verified against nltk source,
``nltk/corpus/reader/wordnet.py:882-929``): for nouns there is no simulated
root; ``depth`` is the max hypernym depth over all noun synsets; and
``lch = -log((shortest_path_distance + 1) / (2 * depth))`` with the distance
computed through common hypernym ancestors.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Taxonomy:
    """Noun taxonomy: synsets with hypernym edges and lemma names.

    ``synsets``: list of (wnid, [lemma_names]); ``hypernyms``: index -> list of
    parent indices (includes instance hypernyms, as nltk's path metrics do).
    """

    def __init__(self, wnids: List[str], lemmas: List[List[str]],
                 hypernyms: List[List[int]]):
        assert len(wnids) == len(lemmas) == len(hypernyms)
        self.wnids = wnids
        self.lemmas = lemmas
        self.hypernyms = hypernyms
        self.wnid_to_idx = {w: i for i, w in enumerate(wnids)}

        # name maps per the reference's get_wordnet_dict
        # (clip_lang_util.py:127-137): first lemma, lowercased, '-' -> '_'
        self.wnid_to_name: Dict[str, str] = {}
        self.name_to_wnids: Dict[str, List[str]] = defaultdict(list)
        for w, ls in zip(wnids, lemmas):
            name = ls[0].lower().replace("-", "_")
            self.wnid_to_name[w] = name
            self.name_to_wnids[name].append(w)

        self._depth: Optional[int] = None

    # ---------------- construction ----------------

    @classmethod
    def from_wndb(cls, db_dir: str) -> "Taxonomy":
        """Parse ``data.noun`` from a WNDB-format dict directory."""
        path = os.path.join(db_dir, "data.noun")
        wnids: List[str] = []
        lemmas: List[List[str]] = []
        raw_hyp: List[List[str]] = []
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("  "):  # license header
                    continue
                data, _, _gloss = line.partition("|")
                fields = data.split()
                if len(fields) < 4:
                    continue
                offset = fields[0]
                w_cnt = int(fields[3], 16)
                words = [fields[4 + 2 * i] for i in range(w_cnt)]
                p_idx = 4 + 2 * w_cnt
                p_cnt = int(fields[p_idx])
                hyp: List[str] = []
                for i in range(p_cnt):
                    sym, tgt_off, pos, _st = fields[p_idx + 1 + 4 * i:
                                                    p_idx + 5 + 4 * i]
                    if sym in ("@", "@i") and pos == "n":
                        hyp.append(tgt_off)
                wnids.append(f"n{int(offset):08d}")
                lemmas.append(list(words))  # WNDB words already use underscores
                raw_hyp.append(hyp)
        off_to_idx = {w[1:]: i for i, w in enumerate(wnids)}
        hypernyms = [[off_to_idx[f"{int(o):08d}"] for o in hs
                      if f"{int(o):08d}" in off_to_idx] for hs in raw_hyp]
        return cls(wnids, lemmas, hypernyms)

    @classmethod
    def from_nltk(cls) -> "Taxonomy":
        # lazy: nltk and its downloaded corpus are optional
        from nltk.corpus import wordnet as wn

        syns = list(wn.all_synsets("n"))
        idx = {s: i for i, s in enumerate(syns)}
        wnids = [f"n{s.offset():08d}" for s in syns]
        lemmas = [list(s.lemma_names()) for s in syns]
        hypernyms = [[idx[h] for h in (s.hypernyms() + s.instance_hypernyms())
                      if h in idx] for s in syns]
        return cls(wnids, lemmas, hypernyms)

    # ---------------- metrics ----------------

    def max_depth(self) -> int:
        """Max hypernym depth over all synsets (root depth 0) — nltk's
        taxonomy ``depth`` for lch (no simulated root for nouns)."""
        if self._depth is not None:
            return self._depth
        n = len(self.wnids)
        depth = [-1] * n

        def d(i: int) -> int:
            # longest path to a root (matches nltk Synset.max_depth)
            stack = [(i, False)]
            while stack:
                node, done = stack.pop()
                if depth[node] >= 0:
                    continue
                if done or not self.hypernyms[node]:
                    depth[node] = (1 + max((depth[h] for h in self.hypernyms[node]),
                                           default=-1))
                else:
                    stack.append((node, True))
                    stack.extend((h, False) for h in self.hypernyms[node]
                                 if depth[h] < 0)
            return depth[i]

        self._depth = max(d(i) for i in range(n))
        return self._depth

    def _ancestor_distances(self, i: int) -> Dict[int, int]:
        """BFS distances from synset i to each hypernym ancestor (incl. self).

        Memoized in a per-instance dict — an ``lru_cache`` on the method
        would key on ``self`` and pin every Taxonomy ever queried (a full
        WordNet instance is ~82k synsets) for the process lifetime, while
        two corpora would compete for one shared LRU."""
        cache = self.__dict__.setdefault("_ancestor_cache", {})
        hit = cache.get(i)
        if hit is not None:
            return hit
        dist = {i: 0}
        frontier = [i]
        while frontier:
            nxt = []
            for u in frontier:
                for h in self.hypernyms[u]:
                    nd = dist[u] + 1
                    if h not in dist or nd < dist[h]:
                        dist[h] = nd
                        nxt.append(h)
            frontier = nxt
        cache[i] = dist
        return dist

    def shortest_path_distance(self, i: int, j: int) -> Optional[int]:
        """Path length through the closest common hypernym (nltk semantics)."""
        if i == j:
            return 0
        di = self._ancestor_distances(i)
        dj = self._ancestor_distances(j)
        common = di.keys() & dj.keys()
        if not common:
            return None
        return min(di[c] + dj[c] for c in common)

    def lch_similarity(self, i: int, j: int) -> Optional[float]:
        depth = self.max_depth()
        dist = self.shortest_path_distance(i, j)
        if dist is None or depth == 0:
            return None
        return -math.log((dist + 1) / (2.0 * depth))

    def name_similarity(self, name_a: str, name_b: str) -> float:
        """Max lch over all synset pairs of the two names
        (reference ``calucate_dis_between_names``, ``main_unsup.py:170-188``)."""
        ids_a = [self.wnid_to_idx[w] for w in self.name_to_wnids.get(name_a, [])]
        ids_b = [self.wnid_to_idx[w] for w in self.name_to_wnids.get(name_b, [])]
        if not ids_a or not ids_b:
            raise KeyError(f"name not in taxonomy: "
                           f"{name_a if not ids_a else name_b!r}")
        sims = [self.lch_similarity(a, b) for a in ids_a for b in ids_b]
        sims = [s for s in sims if s is not None]
        return max(sims)

    def all_names(self) -> List[str]:
        """Unique first-lemma names in synset order (the noun corpus)."""
        seen = set()
        out = []
        for w in self.wnids:
            n = self.wnid_to_name[w]
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out


def _tree_taxonomy(spec: Dict[str, Tuple[Optional[str], List[str]]]) -> Taxonomy:
    """Build a Taxonomy from {wnid: (parent_wnid|None, [lemmas])}."""
    wnids = list(spec.keys())
    idx = {w: i for i, w in enumerate(wnids)}
    lemmas = [spec[w][1] for w in wnids]
    hypernyms = [[idx[spec[w][0]]] if spec[w][0] is not None else []
                 for w in wnids]
    return Taxonomy(wnids, lemmas, hypernyms)


def SyntheticTaxonomy() -> Taxonomy:
    """Small animal/artifact tree for tests (deterministic)."""
    spec = {
        "n00000001": (None, ["entity"]),
        "n00000002": ("n00000001", ["animal"]),
        "n00000003": ("n00000002", ["canine"]),
        "n00000004": ("n00000003", ["dog"]),
        "n00000005": ("n00000003", ["wolf"]),
        "n00000006": ("n00000002", ["feline"]),
        "n00000007": ("n00000006", ["cat"]),
        "n00000008": ("n00000001", ["artifact"]),
        "n00000009": ("n00000008", ["vehicle"]),
        "n00000010": ("n00000009", ["car"]),
        "n00000011": ("n00000009", ["truck"]),
        "n00000012": ("n00000004", ["puppy"]),  # depth 4 -> taxonomy depth 4
    }
    return _tree_taxonomy(spec)
