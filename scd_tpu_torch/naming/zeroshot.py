"""Prompt-ensembled zero-shot vocabulary embedding.

Port of ``scd_tpu/naming/zeroshot.py`` on one device: every name's 80
prompts go through the CLIP text tower in batches of names, and each
name's column is the renormalized mean of its normalized prompt
embeddings.  The large-vocabulary build (:func:`build_zeroshot_weights_
sharded` without a mesh) keeps the JAX package's host-side plan:
length-sorted names, three length-sorted template groups encoded at their
own sequence buckets when that saves a bucket, and EOT-bucket truncation
(exact for a causal tower pooled at EOT).  The prefix-KV build
(``SCD_PREFIX_VOCAB=1``) and the mesh-sharded build are not ported yet
(ROADMAP).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

IMAGENET_TEMPLATE_COUNT = 80

# Sequence buckets of the text tower.  CLIP's text embedding is read at the
# EOT position of a causal transformer, so truncating [N, 77] token rows to
# any length that still holds every row's EOT is exact.
TEXT_SEQ_BUCKETS = (16, 24, 32, 77)


def truncate_to_eot_bucket(tokens: np.ndarray,
                           buckets: Sequence[int] = None) -> np.ndarray:
    """Slice [N, L] token rows to the smallest bucket covering every EOT
    (the per-row argmax id)."""
    if buckets is None:
        buckets = TEXT_SEQ_BUCKETS
    tokens = np.asarray(tokens)
    need = int(tokens.argmax(axis=1).max()) + 1
    return tokens[:, :_bucket_for(need, tokens.shape[1], buckets)]


def _bucket_for(need: int, max_len: int, buckets: Sequence[int] = None) -> int:
    """Smallest bucket covering ``need`` tokens (capped at the row length)."""
    if buckets is None:
        buckets = TEXT_SEQ_BUCKETS
    for b in buckets:
        if b >= need and b <= max_len:
            return b
    return max_len


def _ensemble_reduce(emb: torch.Tensor) -> torch.Tensor:
    """[B, T, D] raw text embeddings -> [B, D] prompt-ensembled weights."""
    emb = emb.float()
    emb = emb / emb.norm(dim=-1, keepdim=True)
    mean = emb.mean(dim=1)
    return mean / mean.norm(dim=-1, keepdim=True)


def build_zeroshot_weights(encode_text_fn: Callable[[List[str]], np.ndarray],
                           classnames: Sequence[str],
                           templates: Sequence[str],
                           names_per_batch: int = 64) -> np.ndarray:
    """The [D, V] zero-shot weight matrix (one column per name).

    ``encode_text_fn`` maps prompt strings to raw embeddings [len, D]
    (numpy or a tensor).  When it also exposes ``forward`` / ``variables``
    / ``tokenize`` (the pipeline's CLIP encoder does) and the vocabulary
    holds at least two batches of names, the batched builder
    :func:`build_zeroshot_weights_sharded` runs; small calls (the
    missing-name repair) encode prompt strings batch by batch."""
    if hasattr(encode_text_fn, "forward") and \
            len(classnames) >= 2 * names_per_batch:
        return build_zeroshot_weights_sharded(
            encode_text_fn.forward, encode_text_fn.variables,
            encode_text_fn.tokenize, classnames, templates,
            names_per_batch=names_per_batch)
    t = len(templates)
    cols = []
    for start in range(0, len(classnames), names_per_batch):
        batch = classnames[start:start + names_per_batch]
        texts = [tmpl.format(name) for name in batch for tmpl in templates]
        emb = torch.as_tensor(np.asarray(encode_text_fn(texts)))
        cols.append(_ensemble_reduce(emb.reshape(len(batch), t, -1)))
    weights = torch.cat(cols).cpu().numpy()  # [V, D]
    return weights.T.astype(np.float32)  # [D, V], the reference layout


def build_zeroshot_weights_sharded(forward, variables, tokenize,
                                   classnames: Sequence[str],
                                   templates: Sequence[str],
                                   names_per_batch: int = 64,
                                   template_groups: int = 3) -> np.ndarray:
    """Batched vocabulary embedding on one device.

    ``forward(variables, tokens [B, L] int32 numpy) -> [B, D]`` is the raw
    text encoder (a device tensor); ``tokenize(texts) -> [len, L] int32``
    runs on the host.  Names go in batches of ``names_per_batch``; the
    device works through batch i while the host tokenizes batch i+1 (the
    results stay on the device until the end).  Host-side plan as in the
    JAX package: names sorted by token length (columns return to the
    original order), templates split into ``template_groups``
    length-sorted groups that are encoded at their own buckets only when
    some group lands in a smaller bucket than the whole batch (the mean
    over templates does not depend on their order).
    """
    t = len(templates)
    b = names_per_batch
    order = None
    if len(classnames) > 4 * b:
        name_tok = np.asarray(tokenize(list(classnames)), np.int32)
        order = np.argsort(name_tok.argmax(axis=1), kind="stable")
        classnames = [classnames[i] for i in order]

    groups = [list(range(t))]
    if (template_groups > 1 and hasattr(tokenize, "prompt_tokens")
            and t >= 8 and len(classnames) > 4 * b):
        tmpl_len = tokenize.prompt_tokens(templates, [""]).argmax(axis=1)
        t_order = np.argsort(tmpl_len, kind="stable")
        groups = [g.tolist()
                  for g in np.array_split(t_order, template_groups)
                  if len(g)]

    cols = []
    for start in range(0, len(classnames), b):
        batch = list(classnames[start:start + b])
        valid = len(batch)
        batch += [batch[-1]] * (b - valid)  # pad with a repeat, drop below
        if hasattr(tokenize, "prompt_tokens"):
            tokens_all = np.asarray(
                tokenize.prompt_tokens(templates, batch), np.int32)
        else:
            texts = [tmpl.format(name) for name in batch
                     for tmpl in templates]
            tokens_all = np.asarray(tokenize(texts), np.int32)  # [b*T, L]
        split = None
        if len(groups) > 1:
            eot = tokens_all.argmax(axis=1).reshape(b, t)
            whole = _bucket_for(int(eot.max()) + 1, tokens_all.shape[1])
            per_g = [_bucket_for(int(eot[:, g].max()) + 1,
                                 tokens_all.shape[1]) for g in groups]
            if any(gb < whole for gb in per_g):
                split = per_g
        if split is not None:
            tok3 = tokens_all.reshape(b, t, -1)
            parts = [forward(variables, np.ascontiguousarray(
                tok3[:, g, :gb].reshape(b * len(g), gb))).reshape(
                    b, len(g), -1) for g, gb in zip(groups, split)]
            col = _ensemble_reduce(torch.cat(parts, dim=1))
        else:
            emb = forward(variables, truncate_to_eot_bucket(tokens_all))
            col = _ensemble_reduce(emb.reshape(b, t, -1))
        cols.append(col[:valid])
    weights = torch.cat(cols).cpu().numpy()  # [V, D]
    if order is not None:  # undo the length sort
        unsorted = np.empty_like(weights)
        unsorted[order] = weights
        weights = unsorted
    return weights.T.astype(np.float32)  # [D, V]
