"""Prompt-ensembled zero-shot vocabulary embedding.

Port of ``scd_tpu/naming/zeroshot.py``: every name's 80 prompts go
through the CLIP text tower in batches of names, and each name's column
is the renormalized mean of its normalized prompt embeddings.  The
large-vocabulary build (:func:`build_zeroshot_weights_sharded`) keeps the
JAX package's host-side plan:
length-sorted names, three length-sorted template groups encoded at their
own sequence buckets when that saves a bucket, and EOT-bucket truncation
(exact for a causal tower pooled at EOT).  The prefix-KV build
(:func:`build_zeroshot_weights_prefix`, opt-in with ``SCD_PREFIX_VOCAB=1``)
encodes each template's shared prefix once and runs only the name and
template-tail tokens of every prompt.  Over a ``mesh``
(``core/mesh.py``) the batched build shards the names over the data axis,
each rank encoding whole names (every template of a name on one rank),
and the [D, V] columns gather on every rank; the prefix route stays off
over several ranks, as the JAX package keeps multi-controller processes
off it.
"""

from __future__ import annotations

import os
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
                           names_per_batch: int = 64,
                           mesh=None) -> np.ndarray:
    """The [D, V] zero-shot weight matrix (one column per name).

    ``encode_text_fn`` maps prompt strings to raw embeddings [len, D]
    (numpy or a tensor).  When it also exposes ``forward`` / ``variables``
    / ``tokenize`` (the pipeline's CLIP encoder does) and the vocabulary
    holds at least two batches of names, the batched builder
    :func:`build_zeroshot_weights_sharded` runs, or, with
    ``SCD_PREFIX_VOCAB=1`` and the prefix hooks ``prefix_forward`` /
    ``suffix_forward`` present (the pipeline sets them unless
    ``dense_int8``), :func:`build_zeroshot_weights_prefix`; small calls
    (the missing-name repair) encode prompt strings batch by batch.
    With a ``mesh`` (a ``core.mesh.MeshContext``; any other object raises)
    and the raw pieces, the batched build shards the names over it."""
    from scd_tpu_torch.core.mesh import check_mesh
    from scd_tpu_torch.core.multihost import is_multiprocess

    mesh = check_mesh(mesh)
    if hasattr(encode_text_fn, "forward") and (
            mesh is not None or len(classnames) >= 2 * names_per_batch):
        # the JAX package keeps multi-controller processes on the full-row
        # build (its pod contracts are proven)
        if (os.environ.get("SCD_PREFIX_VOCAB", "0") == "1"
                and hasattr(encode_text_fn, "prefix_forward")
                and hasattr(encode_text_fn.tokenize, "template_pieces")
                and not is_multiprocess()
                and len(classnames) >= 2 * names_per_batch):
            return build_zeroshot_weights_prefix(
                encode_text_fn.forward, encode_text_fn.prefix_forward,
                encode_text_fn.suffix_forward, encode_text_fn.variables,
                encode_text_fn.tokenize, classnames, templates)
        return build_zeroshot_weights_sharded(
            encode_text_fn.forward, encode_text_fn.variables,
            encode_text_fn.tokenize, classnames, templates,
            names_per_batch=names_per_batch, mesh=mesh)
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
                                   template_groups: int = 3,
                                   mesh=None) -> np.ndarray:
    """Batched (and, over a ``mesh``, name-sharded) vocabulary embedding.

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

    Over a ``mesh`` (``scd_tpu/naming/zeroshot.py:256-411``) every rank
    runs this loop over the SAME full vocabulary (host tokenization is
    repeated; cheap next to the encode) with batches of names padded to a
    multiple of the data-axis size; each rank encodes its contiguous
    whole names of every batch (all their templates), at the batch's
    buckets, and one ``all_gather`` at the end brings every rank's
    columns to every rank.
    """
    t = len(templates)
    n_dev = 1 if mesh is None else mesh.n_data
    b = max(names_per_batch // n_dev, 1) * n_dev  # whole names per shard
    per = b // n_dev
    me = 0 if mesh is None else mesh.data_index
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

    cols, valids = [], []
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
        # this rank's names of the batch (name-major rows: whole names)
        tok3 = tokens_all.reshape(b, t, -1)[me * per:(me + 1) * per]
        if split is not None:
            parts = [forward(variables, np.ascontiguousarray(
                tok3[:, g, :gb].reshape(per * len(g), gb))).reshape(
                    per, len(g), -1) for g, gb in zip(groups, split)]
            col = _ensemble_reduce(torch.cat(parts, dim=1))
        else:
            bucket = truncate_to_eot_bucket(tokens_all).shape[1]
            emb = forward(variables, np.ascontiguousarray(
                tok3[:, :, :bucket].reshape(per * t, bucket)))
            col = _ensemble_reduce(emb.reshape(per, t, -1))
        cols.append(col)
        valids.append(valid)
    if mesh is not None:  # every rank's [batches * per, D] columns
        from scd_tpu_torch.core.multihost import all_gather

        ranks = [g.cpu() for g in all_gather(torch.cat(cols),
                                             group=mesh.data_group)]
        cols = [torch.cat([g[i * per:(i + 1) * per] for g in ranks])
                for i in range(len(valids))]
    weights = torch.cat([c[:v] for c, v in zip(cols, valids)]
                        ).cpu().numpy()  # [V, D]
    if order is not None:  # undo the length sort
        unsorted = np.empty_like(weights)
        unsorted[order] = weights
        weights = unsorted
    return weights.T.astype(np.float32)  # [D, V]


# Suffix-row buckets of the prefix-KV build: name tokens, the template's
# tail and EOT nearly always fit in 8 or 16 tokens.
PREFIX_SUFFIX_BUCKETS = (8, 16)
PREFIX_ROW_MAX = 16  # templates with longer [SOT] + prefix rows fall back


def prefix_plan(tokenize, classnames: Sequence[str],
                templates: Sequence[str]):
    """How :func:`build_zeroshot_weights_prefix` splits the work: returns
    ``(cached, fallback_t, cached_n, fallback_n, name_toks, s_cap)``.
    ``cached`` holds a (prefix row, suffix tail) pair per spliceable
    template whose [SOT] + prefix row fits ``PREFIX_ROW_MAX`` (the tail
    ends in EOT); ``fallback_t`` the other templates' indices;
    ``cached_n`` / ``fallback_n`` the names that splice into every cached
    template / that do not (a punctuation hazard at a boundary, or too
    long for the suffix cap ``s_cap``); ``name_toks`` every name's
    tokens.  With no cached template every name falls back."""
    sot, eot = tokenize.sot_id, tokenize.eot_id
    context_length = 77
    cached, fallback_t = [], []
    any_pre_punct = any_suf_punct = False
    for ti, (pre, suf, _tmpl, pre_p, suf_p) in enumerate(
            tokenize.template_pieces(templates)):
        prow = None if pre is None else [sot] + list(pre)
        if prow is None or len(prow) > PREFIX_ROW_MAX:
            fallback_t.append(ti)
            continue
        cached.append((prow, list(suf) + [eot]))
        any_pre_punct |= pre_p
        any_suf_punct |= suf_p
    name_toks = [tokenize.encode(n) for n in classnames]
    if not cached:
        return cached, fallback_t, [], list(range(len(classnames))), \
            name_toks, 0
    max_plen = max(len(prow) for prow, _ in cached)
    max_tail = max(len(tail) for _, tail in cached)
    s_cap = min(PREFIX_SUFFIX_BUCKETS[-1], context_length - max_plen)
    cached_n, fallback_n = [], []
    for ni, name in enumerate(classnames):
        head_p, tail_p = tokenize.name_boundary_punct(name)
        if ((head_p and any_pre_punct) or (tail_p and any_suf_punct)
                or len(name_toks[ni]) + max_tail + 1 > s_cap):
            fallback_n.append(ni)
        else:
            cached_n.append(ni)
    return cached, fallback_t, cached_n, fallback_n, name_toks, s_cap


def build_zeroshot_weights_prefix(forward, prefix_forward, suffix_forward,
                                  variables, tokenize,
                                  classnames: Sequence[str],
                                  templates: Sequence[str], mesh=None,
                                  names_per_chunk: int = 8192) -> np.ndarray:
    """Prefix-KV vocabulary embedding: each template's shared prefix is
    encoded once, and every prompt runs only its ``name + template tail +
    EOT`` tokens against that cache.

    In a causal tower the prefix activations depend only on the prefix
    tokens, so ``prefix_forward(variables, rows [T, P])`` returns every
    cached template's per-layer (k, v) stacks [depth, T, P, H, d] in one
    pass, and ``suffix_forward(variables, rows [n, s], (k, v), p_len)``
    encodes suffix rows at positions ``p_len + j`` attending [prefix, own
    causal] (``models/clip.py::TextTransformer``).  Per chunk of
    ``names_per_chunk`` length-sorted names: one suffix step per cached
    template adding the normalized embeddings into one f32 [chunk, D] sum
    on the device, one full-row step per fallback template (its rows
    from one ``prompt_tokens`` splice per chunk where the tokenizer has
    it: the same ids as tokenizing each prompt), one finalize (mean,
    renormalize) and one fetch, the fetch two chunks behind so the host
    assembles the next rows while the device works.

    Exactness: the splice is token-exact (``tokenizer.template_pieces``,
    ``name_boundary_punct``) and the attention sees the same keys in the
    same order, so the columns match the full-row build to float rounding.
    What the splice cannot cover falls back: templates without a literal
    '{}' (or whose [SOT] + prefix row is longer than ``PREFIX_ROW_MAX``)
    accumulate through full-row ``forward`` steps; names with a
    punctuation hazard at a boundary, or too long for the suffix bucket,
    go through :func:`build_zeroshot_weights_sharded`.  Port of
    ``scd_tpu/naming/zeroshot.py::build_zeroshot_weights_prefix``; the
    last chunk is not padded to the chunk size, since eager PyTorch
    compiles nothing per shape.

    Over a ``mesh`` of more than one rank (a direct call:
    :func:`build_zeroshot_weights` keeps ranks on the full-row build, as
    the JAX package keeps its multi-controller processes) every rank plans
    the same split and encodes the prefix KV of every cached template
    (small, replicated), then the suffix rows of its contiguous share of
    the length-sorted cached names over the ``data`` axis (padded with a
    repeat of the last name to equal shares, dropped after); one
    ``all_gather`` brings every rank's columns to every rank in name
    order, and the fallback names and templates take
    :func:`build_zeroshot_weights_sharded` over the same mesh.  Every rank
    returns the whole [D, V], as the JAX function's single-controller mesh
    returns it replicated.
    """
    from scd_tpu_torch.core.mesh import check_mesh, single_rank

    mesh = check_mesh(mesh)
    if single_rank(mesh):
        mesh = None
    cached, fallback_t, cached_n, fallback_n, name_toks, s_cap = \
        prefix_plan(tokenize, classnames, templates)
    if not cached or not cached_n:
        return build_zeroshot_weights_sharded(forward, variables, tokenize,
                                              classnames, templates,
                                              mesh=mesh)
    max_plen = max(len(prow) for prow, _ in cached)

    # ---- one pass encodes every cached template's prefix KV
    p_bucket = _bucket_for(max_plen, PREFIX_ROW_MAX,
                           buckets=PREFIX_SUFFIX_BUCKETS)
    prow_mat = np.zeros((len(cached), p_bucket), np.int32)
    for i, (prow, _) in enumerate(cached):
        prow_mat[i, :len(prow)] = prow
    k_all, v_all = prefix_forward(variables, prow_mat)

    order = sorted(cached_n, key=lambda ni: len(name_toks[ni]))
    share = order  # this rank's names, in the sorted order
    if mesh is not None:  # a contiguous share, padded with a repeat
        per = -(-len(order) // mesh.n_data)
        share = (order + order[-1:] * (per * mesh.n_data - len(order)))[
            mesh.data_index * per:(mesh.data_index + 1) * per]
    chunk = max(min(names_per_chunk, len(share)), 1)
    results = []  # (device weights [n, D], rows of `mine`)
    mine = None  # [len(share), D]: the columns of this rank's names

    def drain(upto: int):
        nonlocal mine
        while len(results) > upto:
            w_dev, rows = results.pop(0)
            w = w_dev.cpu().numpy()
            if mine is None:
                mine = np.zeros((len(share), w.shape[1]), np.float32)
            mine[rows] = w

    def add(acc, emb):
        emb = emb.float()
        emb = emb / emb.norm(dim=-1, keepdim=True)
        return emb if acc is None else acc + emb

    for start in range(0, len(share), chunk):
        idxs = share[start:start + chunk]
        n = len(idxs)
        nlen = np.fromiter((len(name_toks[i]) for i in idxs), np.int64, n)
        max_n = int(nlen.max())
        nmat = np.zeros((n, max_n), np.int32)
        for r, i in enumerate(idxs):
            nmat[r, :nlen[r]] = name_toks[i]
        acc = None
        for t_pos, (prow, tail) in enumerate(cached):
            s = _bucket_for(max_n + len(tail), s_cap,
                            buckets=PREFIX_SUFFIX_BUCKETS)
            rows = np.zeros((n, s), np.int32)
            rows[:, :max_n] = nmat
            rows[np.arange(n)[:, None],
                 nlen[:, None] + np.arange(len(tail))[None]] = \
                np.asarray(tail, np.int32)[None]
            acc = add(acc, suffix_forward(
                variables, rows, (k_all[:, t_pos], v_all[:, t_pos]),
                len(prow)))
        if fallback_t:
            fb_templates = [templates[ti] for ti in fallback_t]
            chunk_names = [classnames[i] for i in idxs]
            if hasattr(tokenize, "prompt_tokens"):
                # the ids tokenize(template.format(name)) gives, spliced
                # with each name encoded once: per-prompt BPE of the
                # fallback templates would bound the build on the host
                fb = tokenize.prompt_tokens(fb_templates, chunk_names)
            else:
                fb = tokenize([t.format(x) for x in chunk_names
                               for t in fb_templates])
            fb = np.asarray(fb, np.int32).reshape(n, len(fallback_t), -1)
            for j in range(len(fallback_t)):
                acc = add(acc, forward(variables, truncate_to_eot_bucket(
                    np.ascontiguousarray(fb[:, j]))))
        mean = acc / len(templates)
        results.append((mean / mean.norm(dim=-1, keepdim=True),
                        slice(start, start + n)))
        drain(2)  # two chunks in flight; the host assembles ahead
    drain(0)
    if mesh is not None:  # every rank's share, in the sorted order
        from scd_tpu_torch.core.multihost import all_gather

        mine = torch.cat(all_gather(torch.from_numpy(mine),
                                    group=mesh.data_group)).numpy()
    weights = np.zeros((len(classnames), mine.shape[1]), np.float32)
    weights[order] = mine[:len(order)]

    # ---- fallback names take the full-row build
    if fallback_n:
        w_fb = build_zeroshot_weights_sharded(
            forward, variables, tokenize,
            [classnames[i] for i in fallback_n], templates,
            mesh=mesh)  # [D, M]
        weights[fallback_n] = w_fb.T
    return weights.T.astype(np.float32)  # [D, V], the reference layout
