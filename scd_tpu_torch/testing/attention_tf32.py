"""A CPU emulation of the product contract of the f32 attention kernels at
head_dim 64 (``csrc/attention.cu::attn_f32_wgmma_kernel`` and the two f32
kernels of ``csrc/attention_bwd.cu``).

Every product of two f32 operands is three TF32 products on the tensor
cores: ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)`` (10 mantissa bits,
to nearest, ties away from zero), and ``a . b = a_lo . b_hi + a_hi . b_lo
+ a_hi . b_hi`` (``lo . lo`` dropped, ~2^-22 of |a||b|).  A TF32 product
is exact in f32, so here each of the three is an f32 matmul of the split
operands, summed in f32.  The softmax between the products is f32, as in
the kernels.

:func:`attention_x3` is the forward on [B, L, H, d] tensors; its gradient
by autograd runs every product of the backward (dP = dO . V^T, dV = P^T .
dO, dQ = dS . K, dK = dS^T . Q) through the same three-pass split, as the
gradient kernels do.  ``split=split_bf16`` gives the split-bf16 products
of the repo's other f32 kernels instead, and ``acc=torch.float64`` sums
the split products (and takes the softmax) in float64, which leaves the
split's own error alone.  The CPU tests hold both against the JAX
package's f32 attention at input amplitudes 1, 3 and 6.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 by bit arithmetic: add half of the
    lowest kept bit to the magnitude, clear the 13 low bits (the kernels'
    ``tf32_rna``, ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) of f32 ``x``: its TF32 part and the TF32 of the rest."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_bf16(x: torch.Tensor):
    """(hi, lo) of f32 ``x`` in bf16 (as f32): the split of
    ``csrc/estep.cu``, ``topk_softmax.cu`` and ``fused_em.cu``."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def matmul3(a: torch.Tensor, b: torch.Tensor,
            split: Callable = split_tf32,
            acc: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` as three products of the split f32 operands, the small two
    first: a_lo . b_hi + a_hi . b_lo, then + a_hi . b_hi, in ``acc``."""
    a_hi, a_lo = (t.to(acc) for t in split(a.float()))
    b_hi, b_lo = (t.to(acc) for t in split(b.float()))
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


class _Matmul3(torch.autograd.Function):
    """:func:`matmul3` whose backward products are three-pass too."""

    @staticmethod
    def forward(ctx, a, b, split, acc):
        ctx.save_for_backward(a, b)
        ctx.args = (split, acc)
        return matmul3(a, b, split, acc)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (matmul3(g, b.transpose(-1, -2), *ctx.args),
                matmul3(a.transpose(-1, -2), g, *ctx.args), None, None)


def attention_x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool = False,
                 l_valid: Optional[int] = None, split: Callable = split_tf32,
                 acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention on f32 [B, L, H, d] with every product three-pass:
    s = scale * q . k^T, keys >= l_valid (and, under ``causal``, keys after
    the query) at -inf, p = exp(s - rowmax) / rowsum, out = p . v, in
    ``acc``.  Differentiable (autograd; the backward's products
    three-pass too)."""
    length = q.shape[1]
    lv = length if l_valid is None else min(int(l_valid), length)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, d]
    s = _Matmul3.apply(qh, kh.transpose(-1, -2), split, acc) * scale
    if causal or lv < length:
        col = torch.arange(length, device=q.device)
        keep = (col < lv)[None, :].expand(length, length)
        if causal:
            keep = keep & (col[None, :] <= col[:, None])
        s = s.masked_fill(~keep, float("-inf"))
    e = (s - s.amax(dim=-1, keepdim=True).detach()).exp()
    p = e / e.sum(dim=-1, keepdim=True)
    return _Matmul3.apply(p, vh, split, acc).transpose(1, 2)
