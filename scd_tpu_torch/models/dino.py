"""DINO ViT configs and checkpoint loading.

Port of ``scd_tpu/models/dino.py``: the ViT-B/16, S/16 and Ti/16 configs
and the mapping of facebookresearch/dino state-dict names (the layout the
GCD, PASS and timm checkpoints share) into the tower's parameter tree.
The loader returns the JAX package's Flax-layout tree of numpy arrays;
``models.params.params_from_flax`` moves it into a
:class:`~scd_tpu_torch.models.vit.VisionTransformer`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from scd_tpu_torch.models.vit import ViTConfig


def _vit_config(width: int, heads: int, compute_dtype, gelu_tanh: bool,
                dense_int8: bool) -> ViTConfig:
    return ViTConfig(image_size=224, patch_size=16, width=width, depth=12,
                     heads=heads, quick_gelu=False, pre_post_norm=False,
                     output_proj=None, patch_bias=True, gelu_tanh=gelu_tanh,
                     dense_int8=dense_int8,
                     compute_dtype=compute_dtype or torch.float32)


def dino_vit_b16_config(compute_dtype=None, gelu_tanh: bool = False,
                        dense_int8: bool = False) -> ViTConfig:
    """DINO ViT-B/16 (768-d, 12 heads)."""
    return _vit_config(768, 12, compute_dtype, gelu_tanh, dense_int8)


def dino_vit_s16_config(compute_dtype=None, gelu_tanh: bool = False,
                        dense_int8: bool = False) -> ViTConfig:
    """ViT-S/16 (384-d, 6 heads): the PASS backbone."""
    return _vit_config(384, 6, compute_dtype, gelu_tanh, dense_int8)


def dino_vit_t16_config(compute_dtype=None, gelu_tanh: bool = False,
                        dense_int8: bool = False) -> ViTConfig:
    """ViT-Ti/16 (192-d, 3 heads)."""
    return _vit_config(192, 3, compute_dtype, gelu_tanh, dense_int8)


def _t(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x,
                      dtype=np.float32)


def _flatten_vit_sd(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Unwrap the conventions published ViT checkpoints ship with: weights
    nested under ``teacher`` / ``student`` / ``state_dict`` / ``model``, a
    ``module.`` or ``backbone.`` prefix, and training-only ``head.*`` keys."""
    for wrapper in ("teacher", "student", "state_dict", "model"):
        inner = state_dict.get(wrapper)
        if isinstance(inner, dict) and any("patch_embed" in k
                                           for k in inner):
            state_dict = inner
            break
    out = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "backbone."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("head."):
            continue
        out[k] = v
    return out


def load_dino_weights(state_dict: Dict[str, Any],
                      cfg: Optional[ViTConfig] = None) -> Dict:
    """A DINO / GCD / PASS / timm ViT state dict (``blocks.N.attn.qkv.
    weight`` naming, possibly wrapped) -> the tower's parameter tree
    (``{"params": ...}``, numpy f32, Flax layouts)."""
    cfg = cfg or dino_vit_b16_config()
    sd = {k: _t(v) for k, v in _flatten_vit_sd(state_dict).items()}

    params: Dict[str, Any] = {
        "patch_embed": {
            # torch conv [D, 3, P, P] -> [P, P, 3, D]
            "kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
            "bias": sd["patch_embed.proj.bias"],
        },
        "cls_token": sd["cls_token"].reshape(1, 1, -1),
        "pos_embed": sd["pos_embed"],
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
    }
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        params[f"block_{i}"] = {
            "norm1": {"scale": sd[f"{p}.norm1.weight"],
                      "bias": sd[f"{p}.norm1.bias"]},
            "norm2": {"scale": sd[f"{p}.norm2.weight"],
                      "bias": sd[f"{p}.norm2.bias"]},
            "attn": {
                "qkv": {"kernel": sd[f"{p}.attn.qkv.weight"].T,
                        "bias": sd[f"{p}.attn.qkv.bias"]},
                "proj": {"kernel": sd[f"{p}.attn.proj.weight"].T,
                         "bias": sd[f"{p}.attn.proj.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[f"{p}.mlp.fc1.weight"].T,
                        "bias": sd[f"{p}.mlp.fc1.bias"]},
                "fc2": {"kernel": sd[f"{p}.mlp.fc2.weight"].T,
                        "bias": sd[f"{p}.mlp.fc2.bias"]},
            },
        }
    return {"params": params}
