"""Vision Transformer in PyTorch: the DINO ViT-B/16 and CLIP visual towers.

Port of ``scd_tpu/models/vit.py``.  One parameterized module serves both
families (the differences are config flags): pre-norm blocks, learned CLS
token and position embedding (bicubic-resized for off-grid inputs), the
final LayerNorm on the CLS row only, and for CLIP ``ln_pre`` / ``ln_post``,
QuickGELU and a projection of the CLS feature.

Layouts and dtypes follow the JAX package, so the two are compared like
with like: images enter NHWC, Dense kernels are ``[in, out]``, the patch
kernel is ``[P, P, 3, D]``, and parameter names are the Flax tree's paths
(``block_0.attn.qkv.kernel``; :func:`scd_tpu_torch.models.params.
params_from_flax` moves a Flax tree in).  Parameters are f32; activations
run at ``compute_dtype`` with f32 LayerNorms, and the promotions of the
JAX package carry over (a CLIP tower's residual stream is f32 after
``ln_pre``, a DINO tower's stays at the compute dtype).

``dense_int8`` swaps ``qkv`` and ``fc1`` for :class:`Int8Dense` (W8A8).  On
a CUDA device it follows the JAX package's TPU path: a 2-D input, or a
sequence whose length is a multiple of 16 (``pad_seq_to="auto"`` pads 197
to 208), goes to the fused ``w8a8_fusedq`` kernel with x cast to bf16;
otherwise, or where D is wider than that kernel takes, x is quantized by
the plain chain and the ``w8a8_prequant`` kernel multiplies.  On the CPU it follows the JAX package's off-TPU chain
(quantize the f32 input, int8 product, dequant), which is what the JAX
package computes on a CPU, so the CPU tests compare with it.

Attention goes through :func:`scd_tpu_torch.ops.attention.qkv_attention`
on the packed qkv projection, with the JAX package's masks (pad keys
masked out, causal for the text tower): on a CUDA device the hand-written
kernel (``csrc/attention.cu``), on the CPU its plain version.  With a
cached prefix (``prefix_kv``, the text tower's prefix-KV modes) it goes
through ``ops.attention.prefix_attention`` (``csrc/prefix_attention.cu``
on a CUDA device).

Training: parameters are made with ``requires_grad=False`` (serving builds
no graph); a trainer switches on the ones it trains.  A trainable
:class:`Dense` or :class:`PatchEmbed` casts its parameters inside the
autograd graph, while a frozen one (or any one under ``no_grad``) takes
its one cached cast (``_CastCache``); LayerNorms, the CLS token and the
position embedding are used directly.  A trainable block's attention takes
its gradient from ``csrc/attention_bwd.cu`` through
``ops.attention.AttentionFunction``.  ``remat`` wraps each block that
needs a gradient in ``torch.utils.checkpoint`` (``nn.remat(Block)``); the
int8 layers are for frozen blocks only (``dense_int8_until``), as
quantization has no gradient.

Tensor parallelism (``tp``, a ``core.mesh.ModelGroup``; the trainers
under a ``model`` mesh axis, Megatron's layout): qkv and fc1 are
column-parallel (``copy_to_model`` on the input; under ``dense_int8``
the :class:`Int8Dense` sites too, whose per-row scales are those of the
whole row, since x is replicated), proj and fc2 row-parallel
(``reduce_from_model`` on the partial product, the bias added once
after it).  Each rank attends over its own ``H / tp`` heads.  The text
tower has no ``tp``: nothing trains it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from scd_tpu_torch.core.multihost import copy_to_model, reduce_from_model
from scd_tpu_torch.ops import w8a8
from scd_tpu_torch.ops.attention import (_heads, prefix_attention,
                                         qkv_attention)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Field-for-field the JAX package's ``ViTConfig``; ``compute_dtype``
    is a torch dtype.  See ``scd_tpu/models/vit.py`` for each knob."""

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    quick_gelu: bool = False  # CLIP: x * sigmoid(1.702 x)
    gelu_tanh: bool = False  # tanh-approximate GELU
    pre_post_norm: bool = False  # CLIP: ln_pre / ln_post around the trunk
    output_proj: Optional[int] = None  # CLIP: project CLS to this width
    patch_bias: bool = True  # CLIP's patch conv has no bias
    norm_eps: float = 1e-6  # DINO 1e-6, OpenAI CLIP 1e-5
    compute_dtype: Any = torch.float32
    dense_int8: bool = False  # W8A8 qkv and fc1
    remat: bool = False  # recompute trainable blocks' activations in backward
    dense_int8_until: Optional[int] = None  # quantize blocks i < this only
    # sequence padding for the int8 path: "auto" pads to a multiple of 16
    # when int8 is on, an int forces that length, 0 / None never pads
    pad_seq_to: Any = "auto"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def seq_pad_target(cfg: ViTConfig, real_len: int) -> int:
    """The padded sequence length ``cfg.pad_seq_to`` asks for (>= real_len)."""
    p = cfg.pad_seq_to
    if p == "auto":
        int8_on = cfg.dense_int8 or cfg.dense_int8_until is not None
        return -(-real_len // 16) * 16 if int8_on else real_len
    return max(int(p or 0), real_len)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def _in_graph(p: torch.Tensor) -> bool:
    """A trainable parameter under grad mode: its casts must be recorded
    by autograd, so the frozen parameters' cache does not serve it."""
    return p.requires_grad and torch.is_grad_enabled()


class _CastCache:
    """One derived copy of a parameter (a cast, or the int8 preparation),
    made at first use and again only when the parameter changes."""

    def __init__(self, make):
        self._make = make
        self._key = None
        self._value = None

    def get(self, p: torch.Tensor, *extra):
        key = (p.data_ptr(), p._version, p.device, extra)
        if key != self._key:
            with torch.no_grad():
                self._value = self._make(p, *extra)
            self._key = key
        return self._value


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=compute_dtype)``: x, kernel and bias cast to
    the compute dtype, ``x @ kernel + bias``."""

    def __init__(self, in_dim: int, features: int, compute_dtype,
                 device=None):
        super().__init__()
        self.kernel = _param(in_dim, features, device=device)
        self.bias = _param(features, device=device)
        self.compute_dtype = compute_dtype
        self._w = _CastCache(lambda p, dt: p.to(dt).t())
        self._w32 = _CastCache(lambda p, dt: p.to(dt).float().t())
        self._b = _CastCache(lambda p, dt: p.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if _in_graph(self.kernel):
            return F.linear(x.to(dt), self.kernel.to(dt).t(),
                            self.cast_bias())
        return F.linear(x.to(dt), self._w.get(self.kernel, dt),
                        self.cast_bias())

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ kernel`` without the bias, from the operands cast to the
        compute dtype, summed and returned in f32 (a row-parallel shard's
        partial, :func:`row_parallel`): the products of bf16 operands are
        exact in f32, so the output is rounded to the compute dtype once,
        after the sum over the ranks, as one process's ``forward``
        rounds its f32 accumulator once."""
        dt = self.compute_dtype
        if _in_graph(self.kernel):
            w = self.kernel.to(dt).float().t()
        else:
            w = self._w32.get(self.kernel, dt)
        return F.linear(x.to(dt).float(), w)

    def cast_bias(self) -> torch.Tensor:
        """The bias at the compute dtype (in the graph when it trains)."""
        dt = self.compute_dtype
        if _in_graph(self.bias):
            return self.bias.to(dt)
        return self._b.get(self.bias, dt)


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a column-parallel layer (qkv, fc1) under ``tp`` (a
    ``core.mesh.ModelGroup``, or None): ``core.multihost.copy_to_model``,
    whose backward sums the input gradient over the ``model`` group."""
    return x if tp is None else copy_to_model(x, tp.group)


def row_parallel(dense: "Dense", x: torch.Tensor, tp) -> torch.Tensor:
    """``dense(x)`` for a row-parallel layer (proj, fc2) whose kernel holds
    this rank's rows: the f32 partial product (:meth:`Dense.partial`),
    summed over the ``model`` group (``core.multihost.reduce_from_model``),
    then the bias, added once after the reduction (the JAX spec keeps it
    replicated), and one rounding to the compute dtype.  Without ``tp``,
    ``dense(x)``."""
    if tp is None:
        return dense(x)
    y = reduce_from_model(dense.partial(x), tp.group)
    return (y + dense.cast_bias().float()).to(dense.compute_dtype)


def tp_split(n: int, tp, what: str) -> int:
    """``n`` over the ``model`` axis of ``tp`` (None: ``n``), which must
    divide it."""
    size = 1 if tp is None else tp.size
    if n % size:
        raise ValueError(f"{what} {n} does not split over the {size} ranks "
                         "of the 'model' axis")
    return n // size


class Int8Dense(nn.Module):
    """Dense with W8A8 dynamic quantization: weights per output channel
    (prepared once, in the kernel's layout), activations per token row,
    int32 accumulation, dequant + bias + optional activation (``act``:
    None | "quick_gelu" | "gelu_tanh" | "gelu") in the epilogue.  The
    parameters are those of :class:`Dense`, so every loader works
    unchanged.  See the module docstring for what runs where."""

    def __init__(self, in_dim: int, features: int, out_dtype=None,
                 act: Optional[str] = None, device=None):
        super().__init__()
        if act not in w8a8.ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.kernel = _param(in_dim, features, device=device)
        self.bias = _param(features, device=device)
        self.out_dtype = out_dtype or torch.float32
        self.act = act
        self._prep = _CastCache(lambda p: w8a8.prepare_weight(p))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq_t, s_w = self._prep.get(self.kernel)
        d = x.shape[-1]
        lead = x.shape[:-1]
        f = wq_t.shape[0]
        if x.is_cuda and d <= w8a8.PANEL_MAX_D and (
                x.dim() == 2 or (x.dim() == 3 and x.shape[1] % 16 == 0)):
            # the TPU path: bf16 x into the fused-quantization kernel
            y = w8a8.dense_w8a8_fusedq(
                x.reshape(-1, d).to(torch.bfloat16).contiguous(), wq_t, s_w,
                self.bias, out_dtype=self.out_dtype, act=self.act)
            return y.reshape(*lead, f)
        # the quantization chain, then the pre-quantized product (the
        # w8a8_prequant kernel on a CUDA device, the plain version on the
        # CPU); the activation runs outside at the output dtype
        xq, s_x = w8a8.quantize_rows(x)
        if xq.dim() == 3:
            y = w8a8.dense_w8a8_3d(xq.contiguous(), wq_t, s_x.contiguous(),
                                   s_w, self.bias, out_dtype=self.out_dtype)
        else:
            y = w8a8.dense_w8a8(xq.reshape(-1, d).contiguous(), wq_t,
                                s_x.reshape(-1, 1).contiguous(), s_w,
                                self.bias, out_dtype=self.out_dtype)
        y = w8a8.act_plain(y, self.act)
        return y.reshape(*lead, f)


def _dense(cfg: ViTConfig, in_dim: int, features: int, int8_site: bool = True,
           device=None) -> nn.Module:
    """:class:`Dense` or, under ``cfg.dense_int8`` at an int8 site (qkv,
    fc1), :class:`Int8Dense` writing the compute dtype."""
    if cfg.dense_int8 and int8_site:
        return Int8Dense(in_dim, features, out_dtype=cfg.compute_dtype,
                         device=device)
    return Dense(in_dim, features, cfg.compute_dtype, device=device)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: f32 in, f32 out."""

    def __init__(self, width: int, eps: float, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device),
                                  requires_grad=False)
        self.bias = _param(width, device=device)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            self.eps)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2; under ``tp`` fc1 holds this rank's columns of
    the hidden layer and fc2 its rows (:func:`column_input`,
    :func:`row_parallel`)."""

    def __init__(self, cfg: ViTConfig, device=None, tp=None):
        super().__init__()
        hidden = tp_split(int(cfg.width * cfg.mlp_ratio), tp, "the MLP width")
        self.cfg = cfg
        self.tp = tp
        act = ("quick_gelu" if cfg.quick_gelu
               else ("gelu_tanh" if cfg.gelu_tanh else None))
        # exact-erf GELU stays outside the kernel, as in the JAX package
        self.fused_act = act if cfg.dense_int8 else None
        if self.fused_act is not None:
            self.fc1 = Int8Dense(cfg.width, hidden, out_dtype=cfg.compute_dtype,
                                 act=act, device=device)
        else:
            self.fc1 = _dense(cfg, cfg.width, hidden, device=device)
        self.fc2 = _dense(cfg, hidden, cfg.width, int8_site=False,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.fc1(column_input(x, self.tp)).to(c.compute_dtype)
        if self.fused_act is None:
            if c.quick_gelu:
                x = quick_gelu(x)
            else:
                x = F.gelu(x, approximate="tanh" if c.gelu_tanh else "none")
        return row_parallel(self.fc2, x, self.tp).to(c.compute_dtype)


class Attention(nn.Module):
    """Multi-head self-attention on a packed qkv projection.
    ``real_len``: keys at or beyond it are sequence padding and are masked
    out; ``causal``: the text tower's mask.  ``prefix_kv``: a cached
    prefix's (k, v), each [P, H, d], shared by the batch; the queries then
    attend [prefix, own causal] through :func:`~scd_tpu_torch.ops.
    attention.prefix_attention`, prefix keys at or past ``p_valid`` masked.
    ``return_kv``: also return this layer's (k, v) head views [B, L, H,
    d], the cache a later prefix call feeds back in.  Both serve the
    prefix-KV vocabulary build (``naming/zeroshot.py``).

    Under ``tp`` (a ``core.mesh.ModelGroup``) the rank holds ``H / tp``
    heads: qkv is column-parallel, its packed output ``[q | k | v]`` of
    those heads (``models.params.tp_layout``), attention runs on them,
    and proj, holding their rows, is row-parallel."""

    def __init__(self, cfg: ViTConfig, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.heads = tp_split(cfg.heads, tp, "the head count")
        width = self.heads * (cfg.width // cfg.heads)
        self.qkv = _dense(cfg, cfg.width, 3 * width, device=device)
        self.proj = _dense(cfg, width, cfg.width, int8_site=False,
                           device=device)

    def forward(self, x: torch.Tensor, causal: bool = False,
                real_len: Optional[int] = None, prefix_kv=None,
                p_valid: Optional[int] = None, return_kv: bool = False):
        c = self.cfg
        qkv = self.qkv(column_input(x, self.tp)).to(
            c.compute_dtype).contiguous()
        scale = float(c.width // c.heads) ** -0.5
        if prefix_kv is None and not return_kv:
            out = qkv_attention(qkv, self.heads, scale, causal=causal,
                                l_valid=real_len)
            return row_parallel(self.proj, out, self.tp).to(c.compute_dtype)
        heads = _heads(qkv, self.heads)  # q, k, v [B, L, H, d] views
        if prefix_kv is not None:
            out = prefix_attention(*heads, *prefix_kv, scale,
                                   p_valid).flatten(2)
        else:
            out = qkv_attention(qkv, self.heads, scale, causal=causal,
                                l_valid=real_len)
        out = row_parallel(self.proj, out, self.tp).to(c.compute_dtype)
        return (out, heads[1:]) if return_kv else out


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, tp=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.width, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, device=device, tp=tp)
        self.norm2 = LayerNorm(cfg.width, cfg.norm_eps, device=device)
        self.mlp = Mlp(cfg, device=device, tp=tp)

    def forward(self, x: torch.Tensor, causal: bool = False,
                real_len: Optional[int] = None, prefix_kv=None,
                p_valid: Optional[int] = None, return_kv: bool = False):
        """See :class:`Attention` for ``prefix_kv``, ``p_valid`` and
        ``return_kv`` (which returns ``(x, (k, v))``)."""
        attn = self.attn(self.norm1(x), causal=causal, real_len=real_len,
                         prefix_kv=prefix_kv, p_valid=p_valid,
                         return_kv=return_kv)
        kv = None
        if return_kv:
            attn, kv = attn
        x = x + attn
        x = x + self.mlp(self.norm2(x))
        return (x, kv) if return_kv else x


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on |x| (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in, out] f32 resampling matrix of ``jax.image.resize(...,
    "bicubic")`` along one axis: half-pixel centres, the Keys kernel with
    a = -0.5, widened by the scale when shrinking (antialiasing), weights
    normalized per output sample, zero where the sample lies outside the
    input.  ``F.interpolate(mode="bicubic")`` differs (a = -0.75, no
    antialiasing), so off-grid features would not match the JAX package
    through it."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """Bicubic position-embedding resize for off-grid inputs, as the JAX
    package's (``jax.image.resize`` semantics).  ``pos``: [1, 1+g*g, D]."""
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    g = int(np.sqrt(patch_pos.shape[1]))
    if g == new_grid:
        return pos
    d = patch_pos.shape[-1]
    grid = patch_pos.reshape(g, g, d).float()
    w = bicubic_weights(g, new_grid, device=pos.device)  # [g, new]
    grid = torch.einsum("hwd,hH,wW->HWd", grid, w, w)
    return torch.cat([cls_pos.float(),
                      grid.reshape(1, new_grid * new_grid, d)], dim=1)


def _same_pad(size: int, k: int) -> Tuple[int, int]:
    """Flax ``padding="SAME"`` for a stride-k, k-wide window."""
    out = -(-size // k)
    total = max((out - 1) * k + k - size, 0)
    return total // 2, total - total // 2


class PatchEmbed(nn.Module):
    """Flax ``nn.Conv(width, (P, P), strides=P, padding="SAME")`` on NHWC
    images: with stride equal to the window, the convolution is one matrix
    product over the flattened patches (kernel ``[P, P, 3, D]``)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.cfg = cfg
        self.kernel = _param(p, p, 3, cfg.width, device=device)
        self.bias = _param(cfg.width, device=device) if cfg.patch_bias \
            else None
        self._w = _CastCache(lambda w, dt: w.reshape(-1, w.shape[-1]).to(dt).t())
        self._b = _CastCache(lambda b, dt: b.to(dt))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, int]:
        c, p = self.cfg, self.cfg.patch_size
        dt = c.compute_dtype
        x = images.to(dt)
        b, h, w, ch = x.shape
        (ht, hb), (wl, wr) = _same_pad(h, p), _same_pad(w, p)
        if ht or hb or wl or wr:
            x = F.pad(x, (0, 0, wl, wr, ht, hb))
            h, w = h + ht + hb, w + wl + wr
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, ch).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * ch)
        if _in_graph(self.kernel):
            w = self.kernel.reshape(-1, self.kernel.shape[-1]).to(dt).t()
            bias = None if self.bias is None else self.bias.to(dt)
        else:
            w = self._w.get(self.kernel, dt)
            bias = None if self.bias is None else self._b.get(self.bias, dt)
        return F.linear(x, w, bias), gh


class VisionTransformer(nn.Module):
    """images [B, H, W, 3] (NHWC, normalized floats) -> features
    [B, width or output_proj] f32.  ``tp``: the blocks' tensor-parallel
    context (:class:`Attention`, :class:`Mlp`); every rank of its group
    runs the forward on the same images."""

    def __init__(self, cfg: ViTConfig, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls_token = _param(1, 1, cfg.width, device=device)
        self.pos_embed = _param(1, cfg.seq_len, cfg.width, device=device)
        if cfg.pre_post_norm:
            self.ln_pre = LayerNorm(cfg.width, cfg.norm_eps, device=device)
        for i in range(cfg.depth):
            bc = cfg
            if cfg.dense_int8_until is not None and not cfg.dense_int8:
                bc = dataclasses.replace(cfg,
                                         dense_int8=i < cfg.dense_int8_until)
            self.add_module(f"block_{i}", Block(bc, device=device, tp=tp))
        final = "ln_post" if cfg.pre_post_norm else "norm"
        self.add_module(final, LayerNorm(cfg.width, cfg.norm_eps,
                                         device=device))
        self.proj = (_param(cfg.width, cfg.output_proj, device=device)
                     if cfg.output_proj is not None else None)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x, gh = self.patch_embed(images)
        b = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, c.width), x],
                      dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, gh).to(x.dtype)
        # pad the sequence for the int8 path; pad keys are masked in
        # attention and pad rows never reach the CLS readout
        real_len = x.shape[1]
        pad_to = seq_pad_target(c, real_len)
        rl = None
        if pad_to > real_len:
            x = F.pad(x, (0, 0, 0, pad_to - real_len))
            rl = real_len
        if c.pre_post_norm:
            x = self.ln_pre(x)
        for i in range(c.depth):
            block = getattr(self, f"block_{i}")
            if c.remat and torch.is_grad_enabled() and (
                    x.requires_grad
                    or any(p.requires_grad for p in block.parameters())):
                x = checkpoint(block, x, real_len=rl, use_reentrant=False)
            else:
                x = block(x, real_len=rl)
        final = self.ln_post if c.pre_post_norm else self.norm
        x = final(x[:, :1])[:, 0]
        if self.proj is not None:
            x = torch.matmul(x.float(), self.proj)
        return x.float()


class VisionTransformerWithLinear(nn.Module):
    """ViT trunk + linear classifier on the CLS feature (reference
    ``vision_transformer.py:301-322``), under the Flax names ``base_vit``
    and ``linear``: images -> (logits [B, num_classes], the L2-normalised
    features [B, D]).  The features are normalised before the head and
    returned normalised (reference :316-319): raw-scale logits would shift
    the max-softmax OSR thresholding downstream."""

    def __init__(self, cfg: ViTConfig, num_classes: int = 1000,
                 device=None, tp=None):
        super().__init__()
        self.base_vit = VisionTransformer(cfg, device=device, tp=tp)
        self.linear = Dense(cfg.output_proj or cfg.width, num_classes,
                            torch.float32, device=device)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.base_vit(images).float()
        feats = feats / torch.clamp_min(
            torch.linalg.norm(feats, dim=-1, keepdim=True), 1e-12)
        return self.linear(feats), feats
