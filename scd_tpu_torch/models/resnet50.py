"""ResNet-50 feature extractor (torchvision layout) with load-time BN
folding.

Port of ``scd_tpu/models/resnet50.py`` (reference
``gcd/methods/clustering/extract_features.py:129-141``: frozen 2048-d
features of ``torch.hub dino_resnet50``, and ``timm resnet50`` at
:166-187, both the torchvision layout with ``fc`` replaced by identity).
Extraction is inference-only, so every (conv, BN) pair is folded into the
conv at load time: ``w' = w * gamma / sqrt(var + eps)``, ``b' = beta -
gamma * mean / sqrt(var + eps)`` (exact in f32).  The network is conv +
bias + ReLU only, as in the JAX package.

Images enter NHWC; the parameters keep the Flax names and HWIO layouts
(``layer1_0.conv2.kernel``), so :func:`load_resnet50_weights` returns a
Flax tree for ``params_from_flax``, as the JAX loader does.  The stride
of a bottleneck sits on its 3x3 (torchvision's convention); the stem's
max-pool pads with -inf (``F.max_pool2d``'s implicit padding).  The
convolutions run at ``compute_dtype`` through ``F.conv2d`` (XLA
convolutions in the JAX package, no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.models.dino import _t as _np  # tensor -> f32 numpy
from scd_tpu_torch.models.resnet import Conv


@dataclasses.dataclass(frozen=True)
class ResNet50Config:
    """Bottleneck ResNet.  Defaults are ResNet-50; ``layers`` / ``width``
    are parameterizable so tests can run a tiny variant of the same code
    path.  ``compute_dtype`` is a torch dtype."""
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64  # stem channels; stage c_out = width * 4 * 2^i
    compute_dtype: Any = torch.float32

    def stage_width(self, i: int) -> int:
        return self.width * (2 ** i)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with a projection shortcut, BN
    folded."""

    def __init__(self, cfg: ResNet50Config, in_ch: int, planes: int,
                 stride: int = 1, project: bool = False):
        super().__init__()
        dt = cfg.compute_dtype
        self.conv1 = Conv(in_ch, planes, 1, bias=True, dtype=dt)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=True, dtype=dt)
        self.conv3 = Conv(planes, planes * 4, 1, bias=True, dtype=dt)
        self.down = (Conv(in_ch, planes * 4, 1, stride, bias=True, dtype=dt)
                     if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        if self.down is not None:
            x = self.down(x)
        return F.relu(y + x)


class ResNet50(nn.Module):
    """Pooled-feature tower: images [N, H, W, 3] -> [N, width * 32] f32
    (2048-d at the ResNet-50 default), the reference's ``model.fc =
    Identity`` extraction output."""

    def __init__(self, cfg: ResNet50Config, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.conv1 = Conv(3, cfg.width, 7, 2, 3, bias=True, dtype=dt)
        in_ch = cfg.width
        for i, n_blocks in enumerate(cfg.layers):
            planes = cfg.stage_width(i)
            for j in range(n_blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                self.add_module(f"layer{i + 1}_{j}", Bottleneck(
                    cfg, in_ch, planes, stride, project=(j == 0)))
                in_ch = planes * 4
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = x.to(c.compute_dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for i, n_blocks in enumerate(c.layers):
            for j in range(n_blocks):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
        # global average pool: the mean accumulates in f32 and rounds to
        # the compute dtype, as jnp.mean does, then f32 out
        return x.float().mean(dim=(2, 3)).to(c.compute_dtype).float()


def _fold(sd: Dict[str, np.ndarray], conv: str, bn: str,
          eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Fold BN(conv(x)) into one conv: exact for inference-mode BN."""
    w = sd[f"{conv}.weight"]                      # [out, in, kh, kw] torch
    gamma, beta = sd[f"{bn}.weight"], sd[f"{bn}.bias"]
    mean, var = sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]
    scale = gamma / np.sqrt(var + eps)            # [out]
    kernel = (w * scale[:, None, None, None]).transpose(2, 3, 1, 0)  # HWIO
    bias = beta - mean * scale
    return {"kernel": kernel, "bias": bias}


def load_resnet50_weights(state_dict: Dict[str, Any],
                          cfg: Optional[ResNet50Config] = None,
                          compute_dtype=None) -> Dict:
    """torchvision / dino / timm ``resnet50`` state dict -> the folded
    Flax tree ``{"params": ...}`` (load with ``params_from_flax``).

    Ignores classifier keys (``fc.*``); raises KeyError on a missing conv
    / BN pair so a truncated checkpoint fails loudly."""
    cfg = cfg or ResNet50Config(compute_dtype=compute_dtype or torch.float32)
    sd = {k: _np(v) for k, v in state_dict.items()
          if not k.startswith("fc.")}

    params: Dict[str, Any] = {"conv1": _fold(sd, "conv1", "bn1")}
    for i, n_blocks in enumerate(cfg.layers):
        for j in range(n_blocks):
            p = f"layer{i + 1}.{j}"
            blk = {f"conv{k}": _fold(sd, f"{p}.conv{k}", f"{p}.bn{k}")
                   for k in (1, 2, 3)}
            if f"{p}.downsample.0.weight" in sd:
                blk["down"] = _fold(sd, f"{p}.downsample.0",
                                    f"{p}.downsample.1")
            params[f"layer{i + 1}_{j}"] = blk
    return {"params": params}
