"""The tolerance that holds the attention gradient kernel against autograd
of the plain attention (``ops/attention.py::qkv_attention_bwd_plain``).

Per element of the packed gradient [B, L, 3W] (dQ | dK | dV), with M the
sum of the absolute values of the terms the element sums:

- bf16: ``2^-7 |want| + 2^-6 M``.  Both versions round the f32 sum to bf16
  once (one ulp, 2^-7 relative); a cotangent dP or a p on a bf16 rounding
  boundary in one version only moves its term by one ulp, at most 2^-7 of
  it; the f32 sums run in another order, <= 256 terms, 256 x 2^-24 of M.
- f32: ``1e-4 M``: the same sums, through p's exponent, with no rounding
  to bf16.

M is, with p the softmax and dP = dO . V^T: ``scale * sum_j p (|dP| + A)
|K|`` for dQ with ``A = rowsum(p |dP|)``, the same over the queries with
|Q| for dK, and ``sum_i p |dO|`` for dV, computed in f32 on the inputs'
device, p under the same key mask (``l_valid``, ``causal``) as the
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

BF16_REL, BF16_MASS = 2.0 ** -7, 2.0 ** -6
F32_MASS = 1e-4


def grad_mass(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
              scale: float, l_valid: Optional[int] = None,
              causal: bool = False) -> torch.Tensor:
    """M per element of the packed gradient of ``qkv`` [B, L, 3W] for the
    output gradient ``dout`` [B, L, W]: [B, L, 3W] f32."""
    b, length, w3 = qkv.shape
    d = w3 // (3 * heads)
    lv = length if l_valid is None else min(int(l_valid), length)
    t = qkv.float().unflatten(-1, (3, heads, d)).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]  # [B, H, L, d]
    o = dout.float().reshape(b, length, heads, d).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale  # [B, H, L, L]
    if lv < length:
        s[..., lv:] = float("-inf")
    if causal:
        col = torch.arange(length, device=s.device)
        s.masked_fill_(col[None, :] > col[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    dp = torch.matmul(o, v.transpose(-1, -2)).abs_()
    w = p * (dp + (p * dp).sum(-1, keepdim=True))
    del dp
    mass = torch.stack([scale * torch.matmul(w, k.abs()),
                        scale * torch.matmul(w.transpose(-1, -2), q.abs()),
                        torch.matmul(p.transpose(-1, -2), o.abs())])
    return mass.permute(1, 3, 0, 2, 4).reshape(b, length, w3)


def grad_bound(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
               scale: float, l_valid: Optional[int],
               want: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """The largest |kernel - plain| allowed per element of the packed
    gradient, ``want`` being the plain version's (see the module
    docstring): [B, L, 3W] f32."""
    mass = grad_mass(qkv, dout, heads, scale, l_valid, causal)
    if qkv.dtype == torch.bfloat16:
        return BF16_REL * want.float().abs() + BF16_MASS * mass
    return F32_MASS * mass
