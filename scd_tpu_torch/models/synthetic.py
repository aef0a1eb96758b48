"""Synthetic joint image-text encoder for asset-free end-to-end runs.

Port of ``scd_tpu/models/synthetic.py``.  The pipelines need a stand-in
encoder pair whose image and text embeddings live in one space when no
weights or datasets are at hand: ``encode_image`` projects a
colour-statistics signature through a fixed random MLP; ``encode_text``
embeds a known class name as the projection of that class's canonical
colour (a perfect "caption"), and any other string as a deterministic hash
vector.  The weights come from the same numpy generator as the JAX
package's, so both embed alike.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence

import numpy as np
import torch


class SyntheticCLIP:
    def __init__(self, class_colors: Dict[str, np.ndarray], dim: int = 64,
                 seed: int = 7, device="cpu"):
        self.dim = dim
        rng = np.random.default_rng(seed)
        # fixed 2-layer random projection of a 9-d colour signature
        self.w1 = rng.standard_normal((9, 128)).astype(np.float32) / 3.0
        self.w2 = rng.standard_normal((128, dim)).astype(np.float32) / 11.0
        self.class_colors = {k: np.asarray(v, np.float32)
                             for k, v in class_colors.items()}
        self._names = sorted(self.class_colors, key=len, reverse=True)
        self.device = torch.device(device)
        self._w1 = torch.from_numpy(self.w1).to(self.device)
        self._w2 = torch.from_numpy(self.w2).to(self.device)

    # ------------------------------------------------------------- image side

    @staticmethod
    def _signature(images: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] -> [B,9]: channel means, stds, and mean square."""
        mean = images.mean(dim=(1, 2))
        std = images.std(dim=(1, 2), correction=0)
        sq = (images ** 2).mean(dim=(1, 2))
        return torch.cat([mean, std, sq], dim=-1)

    def encode_image(self, images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images)).to(self.device).float()
        h = torch.tanh(self._signature(x) @ self._w1)
        out = h @ self._w2
        return (out / out.norm(dim=-1, keepdim=True)).cpu().numpy()

    # -------------------------------------------------------------- text side

    def _color_embed(self, color: np.ndarray) -> np.ndarray:
        patch = np.broadcast_to(color.reshape(1, 1, 1, 3), (1, 4, 4, 3))
        return self.encode_image(np.ascontiguousarray(patch))[0]

    def _hash_embed(self, text: str) -> np.ndarray:
        h = int(hashlib.md5(text.encode()).hexdigest(), 16) % (2 ** 32)
        v = np.random.default_rng(h).standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            tl = t.lower()
            hit = next((n for n in self._names
                        if re.search(rf"\b{re.escape(n)}\b", tl)), None)
            if hit is not None:
                out[i] = self._color_embed(self.class_colors[hit])
            else:
                out[i] = self._hash_embed(tl)
        return out


def synthetic_name_similarity(name_a: str, name_b: str) -> float:
    """Stand-in for the WordNet lch similarity on synthetic vocabularies:
    exact match scores the lch self-similarity ceiling, anything else a
    small floor (lch's bounded-below, maximal-at-identity shape)."""
    return 3.6375861597263857 if name_a == name_b else 0.5


def synthetic_vocabulary(class_names: List[str], n_distractors: int = 40,
                         seed: int = 3) -> List[str]:
    """Class names mixed into a larger noun list (stable order)."""
    rng = np.random.default_rng(seed)
    distractors = [f"noun_{i}" for i in range(n_distractors)]
    vocab = sorted(set(class_names) | set(distractors))
    rng.shuffle(vocab)
    return vocab
