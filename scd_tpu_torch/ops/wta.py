"""Winner-take-all (WTA) hashing of embedding vectors.

Port of ``scd_tpu/ops/wta.py`` (reference ``local_utils/wta.py``, an
orphan TensorFlow experiment): sample ``hash_code_dim`` random windows of
``hash_win_len`` feature indices and keep the argmax position within each
window, turning a dense embedding into an ordinal hash code that is robust
to monotone feature rescaling.

The window indices come from an explicit ``torch.Generator`` (the port
does not reproduce ``jax.random``'s threefry draws: the same seed gives
other windows than the JAX package's, with the same properties); given
the same indices :func:`wta_hash` is bit-equal to the JAX package's (the
first index of a tied maximum).  Gather and argmax run where the
features lie.
"""

from __future__ import annotations

import torch


def structured_hash_idx(gen: torch.Generator, embed_dim: int,
                        hash_code_dim: int,
                        hash_win_len: int) -> torch.Tensor:
    """[hash_code_dim, hash_win_len] int64 index matrix on ``gen``'s
    device: each row is the first ``hash_win_len`` entries of an
    independent permutation of ``range(embed_dim)`` (reference
    ``get_structured_hash_idx``, ``wta.py:8-12``)."""
    if not 0 < hash_win_len <= embed_dim:
        raise ValueError(f"hash_win_len {hash_win_len} not in [1, "
                         f"{embed_dim}]")
    keys = torch.rand(hash_code_dim, embed_dim, generator=gen,
                      device=gen.device)
    return torch.argsort(keys, dim=1)[:, :hash_win_len]


def wta_hash(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, D] features, [C, W] window indices -> [B, C] int64 codes: the
    argmax position within each window (reference ``hash_transform``,
    ``wta.py:14-24``)."""
    windows = features[:, idx.to(features.device)]  # [B, C, W]
    return torch.argmax(windows, dim=-1)


def hash_transform(gen: torch.Generator, features: torch.Tensor,
                   hash_code_dim: int, hash_win_len: int) -> torch.Tensor:
    """One-call form matching the reference API."""
    if features.dim() != 2:
        raise ValueError("expected [batch, embed_dim] features")
    idx = structured_hash_idx(gen, features.shape[1], hash_code_dim,
                              hash_win_len)
    return wta_hash(features, idx)
