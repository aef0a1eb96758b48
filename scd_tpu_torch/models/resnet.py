"""Two-head ResNet (the AutoNovel baseline backbone).

Port of ``scd_tpu/models/resnet.py`` (reference
``gcd/models/resnet_twohead.py:14-79``): a CIFAR-style ResNet-18 (3x3
stem, four BasicBlock stages 64/128/256/512) with two linear heads, one
over labelled classes, one over unlabelled.

As in the JAX package: NHWC images in, GroupNorm (32 groups) in place of
BatchNorm, convolutions at ``dtype`` with the norms in f32.  The
parameters keep the Flax names and layouts (``layer2_0.conv1.kernel``
``[kh, kw, in, out]``, HWIO), so ``params_from_flax`` loads a JAX tree
one to one; the convolutions take the kernel as OIHW views.  Inside, the
activations are NCHW views of channels-last memory (the NHWC input
permuted), which cuDNN takes as they are.  Flax's GroupNorm differs from
``nn.GroupNorm``: epsilon 1e-6, and the variance E[x^2] - E[x]^2 in f32
(clipped at 0), so :class:`GroupNorm` computes it so.  The convolutions
are XLA convolutions in the JAX package (no Pallas kernel), so
``F.conv2d`` is their counterpart.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.models.vit import Dense


class Conv(nn.Module):
    """Flax ``nn.Conv(features, (k, k), strides=s, padding=p,
    dtype=dtype)`` on NCHW activations: input, kernel and bias cast to
    ``dtype``.  ``padding`` is symmetric (Flax's ``SAME`` for the 1x1
    convolutions here is 0)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, k, in_ch, out_ch),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_ch), requires_grad=False)
                     if bias else None)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.kernel.to(dt).permute(3, 2, 0, 1)  # HWIO -> OIHW
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), w, b, self.stride, self.padding)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(num_groups, dtype=float32)`` on NCHW: statistics
    over each group's channels and the spatial axes in f32, var = E[x^2] -
    E[x]^2 clipped at 0, y = (x - mean) * (rsqrt(var + 1e-6) * scale) +
    bias, f32 out."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = self.num_groups
        x = x.float()
        xg = x.reshape(n, g, c // g, h, w)
        mean = xg.mean(dim=(2, 3, 4))
        var = torch.clamp_min((xg * xg).mean(dim=(2, 3, 4)) - mean * mean,
                              0.0)
        mean = mean.repeat_interleave(c // g, dim=1)[:, :, None, None]
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1)
               * self.scale)[:, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]


class BasicBlock(nn.Module):
    """Pre-activation-free basic residual block (reference
    ``resnet_twohead.py:49-71``)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_ch, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = GroupNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = GroupNorm(planes)
        if stride != 1 or in_ch != planes:
            self.shortcut = Conv(in_ch, planes, 1, stride, dtype=dtype)
            self.shortcut_norm = GroupNorm(planes)
        else:
            self.shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.shortcut is not None:
            x = self.shortcut_norm(self.shortcut(x))
        return F.relu(x + y)


class ResNetTwoHead(nn.Module):
    """ResNet-18 trunk + (labelled, unlabelled) heads: images [N, H, W, 3]
    -> (out_labelled, out_unlabelled, features [N, 512] f32), like the
    reference's ``forward(..., output='both')``."""

    def __init__(self, num_labeled_classes: int = 5,
                 num_unlabeled_classes: int = 5,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_blocks = tuple(num_blocks)
        self.conv1 = Conv(3, 64, 3, 1, 1, dtype=dtype)
        self.bn1 = GroupNorm(64)
        in_ch = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                self.num_blocks)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"layer{stage + 1}_{i}", BasicBlock(
                    in_ch, planes, stride, dtype))
                in_ch = planes
        f32 = torch.float32
        self.head1 = Dense(in_ch, num_labeled_classes, f32)
        self.head2 = Dense(in_ch, num_unlabeled_classes, f32)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        for stage, n in enumerate(self.num_blocks):
            for i in range(n):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
        feats = x.mean(dim=(2, 3)).float()  # global average pool
        return self.head1(feats), self.head2(feats), feats
