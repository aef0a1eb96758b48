"""CLIP ViT-B/16 (image and text towers) with OpenAI checkpoint loading.

Port of ``scd_tpu/models/clip.py``: the visual tower is
:class:`~scd_tpu_torch.models.vit.VisionTransformer`; the text tower is a
causal pre-norm transformer over token and position embeddings, pooled at
the EOT token (the highest id of each row) and projected.  Under the int8
knob (one knob quantizes both towers) the token sequence is padded to a
multiple of 16; the causal mask already hides the pad keys from every real
query, and pooling reads a real position.  Both towers' attention is the
port's own (``ops/attention.py``: the ``csrc/attention.cu`` kernel on a
CUDA device, causal for the text tower).  The text tower's prefix-KV
modes serve the ``SCD_PREFIX_VOCAB=1`` vocabulary build
(:meth:`CLIPModel.encode_text_prefix`, :meth:`CLIPModel.
encode_text_suffix`); their attention is ``ops.attention.
prefix_attention`` (``csrc/prefix_attention.cu`` on a CUDA device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.models.vit import (Block, LayerNorm, ViTConfig,
                                      VisionTransformer, _param,
                                      seq_pad_target)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: ViTConfig
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_depth: int = 12
    text_heads: int = 8
    embed_dim: int = 512
    compute_dtype: Any = torch.float32

    def text_block_config(self) -> ViTConfig:
        """The text tower's block config (QuickGELU, torch's LayerNorm eps;
        ``dense_int8`` follows the visual tower's)."""
        return ViTConfig(width=self.text_width, depth=self.text_depth,
                         heads=self.text_heads, quick_gelu=True,
                         norm_eps=1e-5, dense_int8=self.vision.dense_int8,
                         compute_dtype=self.compute_dtype)


def clip_vit_b16_config(compute_dtype=torch.float32,
                        dense_int8: bool = False) -> CLIPConfig:
    return CLIPConfig(
        vision=ViTConfig(image_size=224, patch_size=16, width=768, depth=12,
                         heads=12, quick_gelu=True, pre_post_norm=True,
                         output_proj=512, patch_bias=False,
                         dense_int8=dense_int8, norm_eps=1e-5,
                         compute_dtype=compute_dtype),
        compute_dtype=compute_dtype)


class TextTransformer(nn.Module):
    """tokens [B, L] int -> text features [B, embed_dim] f32 (not
    normalized)."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = _param(cfg.vocab_size, cfg.text_width,
                                      device=device)
        self.pos_embed = _param(cfg.context_length, cfg.text_width,
                                device=device)
        blk = cfg.text_block_config()
        for i in range(cfg.text_depth):
            self.add_module(f"block_{i}", Block(blk, device=device))
        self.ln_final = LayerNorm(cfg.text_width, 1e-5, device=device)
        self.text_projection = _param(cfg.text_width, cfg.embed_dim,
                                      device=device)

    def forward(self, tokens: torch.Tensor, prefix_kv=None,
                p_len: Optional[int] = None, return_prefix_kv: bool = False):
        """Prefix-KV modes (the prefix-KV vocabulary build):

        * ``return_prefix_kv=True``: tokens are prefix rows [T, P]
          (SOT-framed, zero-padded); returns the per-layer (k, v) head
          projections as ``(k_stack, v_stack)``, each [depth, T, P, heads,
          head_dim].  Causal masking keeps the padding out of the prefix
          activations, so the cache is exact.
        * ``prefix_kv=(k, v)`` (each [depth, P, heads, head_dim]) and
          ``p_len`` (the real prefix length): tokens are suffix rows [B, S]
          (name, template tail, EOT, zero-padded) at positions ``p_len +
          j``, attending [cached prefix, own causal]; the result equals the
          full-row forward on the prefix + suffix rows.

        Neither mode pads the sequence for the int8 path."""
        c = self.cfg
        b, length = tokens.shape
        tokens = tokens.long()
        if prefix_kv is None:
            pos = self.pos_embed[:length]
        else:
            p_len = int(p_len)
            if not 0 <= p_len <= c.context_length - length:
                raise ValueError(f"suffix rows of {length} tokens after a "
                                 f"prefix of {p_len} pass the context "
                                 f"length {c.context_length}")
            pos = self.pos_embed[p_len:p_len + length]
        x = (self.token_embedding[tokens] + pos[None]).to(c.compute_dtype)
        pad_to = seq_pad_target(c.text_block_config(), length)
        if pad_to > length and prefix_kv is None and not return_prefix_kv:
            x = F.pad(x, (0, 0, 0, pad_to - length))
        kvs = []
        for i in range(c.text_depth):
            layer_kv = None if prefix_kv is None else (prefix_kv[0][i],
                                                       prefix_kv[1][i])
            x = getattr(self, f"block_{i}")(
                x, causal=True, prefix_kv=layer_kv, p_valid=p_len,
                return_kv=return_prefix_kv)
            if return_prefix_kv:
                x, kv = x
                kvs.append(kv)
        if return_prefix_kv:
            return (torch.stack([k for k, _ in kvs]),
                    torch.stack([v for _, v in kvs]))
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eot]
        return torch.matmul(pooled.float(), self.text_projection)


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, device=device)
        self.text = TextTransformer(cfg, device=device)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32,
                         device=device), requires_grad=False)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def encode_text_prefix(self, tokens: torch.Tensor):
        """Prefix rows [T, P] -> the per-layer KV cache (see
        :meth:`TextTransformer.forward`)."""
        return self.text(tokens, return_prefix_kv=True)

    def encode_text_suffix(self, tokens: torch.Tensor, prefix_kv,
                           p_len: int) -> torch.Tensor:
        """Suffix rows [B, S] and one template's cache -> [B, D]
        features."""
        return self.text(tokens, prefix_kv=prefix_kv, p_len=p_len)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.t()


# ----------------------------------------------------------- weight loading

def _t(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def load_openai_clip_weights(state_dict: Dict[str, Any],
                             cfg: Optional[CLIPConfig] = None) -> Dict:
    """An OpenAI CLIP ViT state dict (``visual.transformer.resblocks.N.
    attn.in_proj_weight`` etc.; torch tensors or numpy arrays) -> the
    model's parameter tree (``{"params": ...}``, numpy f32, Flax
    layouts)."""
    cfg = cfg or clip_vit_b16_config()
    sd = {k: _t(v.cpu().numpy() if hasattr(v, "cpu") else v)
          for k, v in state_dict.items()}

    def block_params(prefix: str) -> Dict:
        return {
            "norm1": {"scale": sd[f"{prefix}.ln_1.weight"],
                      "bias": sd[f"{prefix}.ln_1.bias"]},
            "norm2": {"scale": sd[f"{prefix}.ln_2.weight"],
                      "bias": sd[f"{prefix}.ln_2.bias"]},
            "attn": {
                "qkv": {"kernel": sd[f"{prefix}.attn.in_proj_weight"].T,
                        "bias": sd[f"{prefix}.attn.in_proj_bias"]},
                "proj": {"kernel": sd[f"{prefix}.attn.out_proj.weight"].T,
                         "bias": sd[f"{prefix}.attn.out_proj.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[f"{prefix}.mlp.c_fc.weight"].T,
                        "bias": sd[f"{prefix}.mlp.c_fc.bias"]},
                "fc2": {"kernel": sd[f"{prefix}.mlp.c_proj.weight"].T,
                        "bias": sd[f"{prefix}.mlp.c_proj.bias"]},
            },
        }

    visual = {
        # torch conv [D, 3, P, P] -> [P, P, 3, D]
        "patch_embed": {"kernel": sd["visual.conv1.weight"].transpose(
            2, 3, 1, 0)},
        "cls_token": sd["visual.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd["visual.positional_embedding"][None],
        "ln_pre": {"scale": sd["visual.ln_pre.weight"],
                   "bias": sd["visual.ln_pre.bias"]},
        "ln_post": {"scale": sd["visual.ln_post.weight"],
                    "bias": sd["visual.ln_post.bias"]},
        "proj": sd["visual.proj"],
    }
    for i in range(cfg.vision.depth):
        visual[f"block_{i}"] = block_params(
            f"visual.transformer.resblocks.{i}")

    text = {
        "token_embedding": sd["token_embedding.weight"],
        "pos_embed": sd["positional_embedding"],
        "ln_final": {"scale": sd["ln_final.weight"],
                     "bias": sd["ln_final.bias"]},
        "text_projection": sd["text_projection"],
    }
    for i in range(cfg.text_depth):
        text[f"block_{i}"] = block_params(f"transformer.resblocks.{i}")

    return {"params": {"visual": visual, "text": text,
                       "logit_scale": sd["logit_scale"].reshape(())}}
