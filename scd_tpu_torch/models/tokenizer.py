"""CLIP byte-pair-encoding tokenizer (self-contained host implementation).

Port of ``scd_tpu/models/tokenizer.py`` (``CLIPTokenizer`` with the
compositional ``prompt_tokens`` / ``template_pieces`` the vocabulary build
uses, and the asset-free ``HashTokenizer``): the byte-to-unicode table, end-of-word markers, merge ranks and the
CLIP text regex, with the merges read from a configurable path
(``bpe_simple_vocab_16e6.txt.gz`` in the CLIP release).  Without the
``regex`` package the standard ``re`` module takes over with an
equivalent pattern.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:
    import regex as re
    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re  # type: ignore

    _HAS_REGEX = False

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode table (standard GPT-2/CLIP BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _is_punct(ch: str) -> bool:
    """True for a single char the CLIP regex lumps into a ``[^\\s\\w]+``
    punctuation run (empty string -> False)."""
    return bool(ch) and not ch.isspace() and not ch.isalnum()


def _clean(text: str) -> str:
    # reference also runs ftfy.fix_text (mojibake repair) — a no-op for the
    # ASCII prompt templates and class names this pipeline tokenizes
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]

        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT, EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT: SOT, EOT: EOT}
        self._template_pieces_cache: Dict[tuple, list] = {}
        if _HAS_REGEX:
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                re.IGNORECASE)
        else:  # pragma: no cover — stdlib re cannot compile \p classes;
            # [^\W\d_] == unicode letters, \d == digits under re.UNICODE
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                r"""[^\W\d_]+|\d|[^\s\w]+""",
                re.IGNORECASE | re.UNICODE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for tok in re.findall(self.pat, _clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def __call__(self, texts: Sequence[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to a fixed [B, context_length] int32 batch, SOT/EOT framed,
        truncated like ``clip.tokenize(truncate=True)``."""
        sot, eot = self.encoder[SOT], self.encoder[EOT]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = eot
            out[i, :len(toks)] = toks
        return out

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT]

    def template_pieces(self, templates: Sequence[str]) -> list:
        """Per-template splice pieces: ``(pre_tokens, suf_tokens, template,
        pre_punct, suf_punct)`` — ``pre_tokens is None`` marks a template
        that cannot be spliced (no literal word-boundary ``{}``).

        Splicing is only exact when the placeholder is a literal '{}' at
        word boundaries; otherwise ('{0}'/'{name}' placeholders, or a glued
        '{}s') callers must fall back to per-pair ``encode(t.format(n))`` —
        slower but always equal to the non-compositional path.  A prefix
        ENDING in an ASCII apostrophe is also unsafe regardless of the
        name: the regex contraction alternatives ('s|'t|'re|'ve|'m|'ll|'d)
        fuse the apostrophe with a following letter in the full encode
        (e.g. "o'{}" + "sock" -> "'s" token) where the splice keeps them
        apart.  The remaining merge hazard is name-dependent: a PUNCT
        template boundary next to a PUNCT name boundary fuses into one
        ``[^\\s\\w]+`` regex token in the full encode (e.g. name 'ph.d.' +
        template '... {}.') — the returned boundary classes let callers
        fall back per name (see ``name_boundary_punct``).

        Pieces are constant across the vocabulary build's ~1k batch calls,
        so they cache per templates-tuple."""
        key = tuple(templates)
        pieces = self._template_pieces_cache.get(key)
        if pieces is None:
            pieces = _split_template_pieces(self.encode, templates)
            self._template_pieces_cache[key] = pieces
        return pieces

    name_boundary_punct = staticmethod(
        lambda name: _name_boundary_punct(name))

    def prompt_tokens(self, templates: Sequence[str], names: Sequence[str],
                      context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize ``template.format(name)`` for every (name, template)
        pair WITHOUT running BPE per pair.

        CLIP tokenization is compositional at the regex-word level: the
        pattern splits the cleaned text into words/punctuation first and
        BPE runs per word with no cross-word context, so
        ``encode(t.format(n)) == encode(prefix) + encode(n) +
        encode(suffix)`` whenever ``{}`` sits at word boundaries (true of
        all 80 ImageNet templates — the name is always whitespace- or
        punctuation-delimited).  Each template's prefix/suffix and each
        name is encoded ONCE per call (template pieces additionally cache
        across calls): a V-name x 80-template vocabulary build runs V name
        encodes plus an O(1) splice per prompt instead of 80 V full
        tokenizations.

        Output layout matches ``self([t.format(n) for n in names for t in
        templates])``: name-major, template-minor.
        """
        return _splice_prompt_tokens(self.encode, self.sot_id, self.eot_id,
                                     self.template_pieces(templates),
                                     templates, names, context_length)


def _split_template_pieces(encode, templates: Sequence[str]) -> list:
    """Shared piece-splitting behind ``template_pieces`` (see the method
    docstring for the exactness rules)."""
    pieces = []
    for t in templates:
        pre, sep, suf = t.partition("{}")
        exact = (bool(sep)
                 and not (pre and pre[-1].isalnum())
                 and not pre.endswith("'")
                 and not (suf and suf[0].isalnum()))
        if exact:
            pieces.append((encode(pre), encode(suf), t,
                           _is_punct(pre[-1:]), _is_punct(suf[:1])))
        else:
            pieces.append((None, None, t, False, False))
    return pieces


def _name_boundary_punct(name: str) -> tuple:
    """(head_punct, tail_punct) hazard classes of a class name — True when
    the cleaned name starts/ends with a char the CLIP regex lumps into a
    punctuation run (empty names count as both: the template pieces become
    directly adjacent in the full encode)."""
    nc = _clean(name)
    empty = not nc
    return (empty or _is_punct(nc[:1]), empty or _is_punct(nc[-1:]))


def _splice_prompt_tokens(encode, sot: int, eot: int, pieces,
                          templates, names, context_length) -> np.ndarray:
    """Shared splice loop behind ``prompt_tokens`` (name-major layout,
    hazard pairs fall back to full ``encode(t.format(n))``)."""
    name_toks = [encode(n) for n in names]
    out = np.zeros((len(names) * len(templates), context_length), np.int32)
    row = 0
    for name, ntoks in zip(names, name_toks):
        # an empty (or whitespace-only) name makes pre and suf directly
        # adjacent in the full encode, where a punct-punct meeting fuses
        # into one [^\s\w]+ run — treat both boundaries as hazardous so
        # punctuation-flanked templates fall back to the per-pair encode
        n_head_punct, n_tail_punct = _name_boundary_punct(name)
        for pre, suf, tmpl, pre_punct, suf_punct in pieces:
            if (suf is None or (pre_punct and n_head_punct)
                    or (suf_punct and n_tail_punct)):
                # fallback: full format+encode (non-splittable template,
                # or punctuation-adjacent boundary that would merge)
                toks = [sot] + encode(tmpl.format(name)) + [eot]
            else:
                toks = [sot] + pre + ntoks + suf + [eot]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = eot
            out[row, :len(toks)] = toks
            row += 1
    return out


class HashTokenizer:
    """Deterministic fallback with the CLIP tokenizer interface: words hash
    into the CLIP vocab id range.  For tests / missing-asset environments —
    NOT compatible with real CLIP checkpoints.

    Text splits with the same word/punct regex shape as the CLIP BPE
    pattern (letter runs | single digits | punctuation runs | contraction
    alternatives), so the compositional splice machinery —
    ``template_pieces`` / ``prompt_tokens`` / the prefix-cached vocabulary
    build — has the SAME exactness and hazard semantics as the real
    tokenizer and can be exercised without the BPE asset."""

    _word_re = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
        re.IGNORECASE | re.UNICODE)

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1
        self._template_pieces_cache: Dict[tuple, list] = {}

    def encode(self, text: str) -> List[int]:
        import hashlib

        out = []
        for word in self._word_re.findall(_clean(text)):
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            out.append(h % (self.vocab_size - 2))
        return out

    def __call__(self, texts: Sequence[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            toks = toks[:context_length]
            if toks[-1] != self.eot:
                toks[-1] = self.eot
            out[i, :len(toks)] = toks
        return out

    @property
    def sot_id(self) -> int:
        return self.sot

    @property
    def eot_id(self) -> int:
        return self.eot

    def template_pieces(self, templates: Sequence[str]) -> list:
        """CLIPTokenizer-compatible splice pieces (same regex-word
        compositionality — see ``_split_template_pieces``)."""
        key = tuple(templates)
        pieces = self._template_pieces_cache.get(key)
        if pieces is None:
            pieces = _split_template_pieces(self.encode, templates)
            self._template_pieces_cache[key] = pieces
        return pieces

    name_boundary_punct = staticmethod(
        lambda name: _name_boundary_punct(name))

    def prompt_tokens(self, templates: Sequence[str], names: Sequence[str],
                      context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Compositional (name, template) batch tokenization — same
        contract as ``CLIPTokenizer.prompt_tokens``."""
        return _splice_prompt_tokens(self.encode, self.sot_id, self.eot_id,
                                     self.template_pieces(templates),
                                     templates, names, context_length)
