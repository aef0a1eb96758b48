"""Masked softmax attention for the towers' sequences.

Port of ``scd_tpu/ops/pallas_kernels.py::vit_attention_pallas`` and
``::qkv_attention_pallas``, with the JAX layouts at the public functions:

- :func:`vit_attention` takes q, k, v [B, L, H, d] and returns [B, L, H, d];
- :func:`qkv_attention` takes the packed projection [B, L, 3W] (q | k | v
  on the feature axis, the output of the towers' fused ``qkv`` Dense) and
  returns [B, L, W].

Both compute scores in f32 from products of the input type, times
``scale``; mask keys at or past ``l_valid`` and, under ``causal``, keys
after the query; take the softmax in f32 (row max, exp, divide by the row
sum); round p to v's type; and accumulate p . v in f32, stored in v's type.

Dispatch by device: a CUDA tensor runs the hand-written kernels
(``csrc/attention.cu``; one library for both entry points, since a packed
qkv is three strided [B, L, H, d] views of one buffer), chosen by shape in
the C entry point by the rules of :func:`attention_route`.  At head_dim 64
(every shipped image and text tower) the tensor-core paths, which take
16-byte-aligned views and raise on others: bf16 at L <= 256 the whole-row
``wgmma`` path, past it the key-tiled ``wgmma`` long path; f32 at any L
one kernel whose products are three TF32 passes on ``wgmma`` (below).
Another head_dim (the micro ViT's 32) takes the SIMT kernels: f32 at L <=
256 the whole-row one where its rows fit in shared memory; bf16 at any L,
and f32 otherwise, the key-tiled one (head_dim <= 256).  A CPU tensor runs
:func:`attention_plain`.  There is no fallback: a CUDA tensor no kernel
takes raises.

The f32 products.  Each f32 product is three TF32 products on the tensor
cores, summed in f32: ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)``,
``a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi`` (``lo . lo``, ~2^-22
of |a||b|, dropped).  One TF32 pass keeps ~3 decimal digits, which the
repo's parity rule refuses; the split-bf16 products of the other f32
kernels (``estep.cu``, ``topk_softmax.cu``, ``fused_em.cu``, ~2^-16)
lose too much where the softmax is sharp: on inputs of amplitude 3 the
attention's error from the split alone reads 3.5e-5 of max|v|, three
times the f32 tolerance of 1e-5 (``chip_smoke.ATTN_F32_VREL``); the TF32
split reads 4.5e-7 there and 1.6e-6 at amplitude 6, below f32
arithmetic's own error (``tests/test_torch_attention.py``).  The SIMT
kernels at other head_dims keep f32 products exact.

The gradient: :func:`qkv_attention` routes through
:class:`AttentionFunction` whenever grad mode is on and the packed qkv
requires a gradient (the trainable blocks of a training step); otherwise
it launches as above, so serving and the pipelines are unchanged.  The
Function's forward is the dispatch above; its backward is the
hand-written ``csrc/attention_bwd.cu`` on a CUDA tensor
(:func:`qkv_attention_bwd_cuda`, causal or not, by :func:`bwd_route`: at
head_dim 64 and any L, 16-byte-aligned views, two ``wgmma`` kernels fed by
TMA, bf16 or f32 (the f32 ones on three TF32 passes, as the forward);
another head_dim <= 256, bf16 or f32, any L, two SIMT kernels that stream
the keys in tiles; anything else raises) and autograd through
:func:`attention_plain` on a CPU tensor (:func:`qkv_attention_bwd_plain`,
also the card's reference).  The JAX package differentiates its attention
with XLA autodiff, so the kernel replaces no Pallas kernel.  The gradient
lands in one packed [B, L, 3W] buffer, the gradient of the qkv Dense's
output.

Prefix attention (:func:`prefix_attention`, the prefix-KV vocabulary
build's text tower): suffix queries q [B, S, H, d] attend the keys
[prefix, suffix]: a per-template prefix pk / pv [P, H, d] shared by the
whole batch, its keys at or past ``p_valid`` (pad tokens) masked, then
their own suffix keys k / v [B, S, H, d] under a causal mask.  The
contract is the one above (scores in f32 from products of the input type,
softmax in f32, p rounded to v's type, p . v accumulated in f32 and stored
in v's type).  The JAX package's ``_prefix_attention``
(``scd_tpu/models/vit.py``) stores its scores at the compute dtype, so
under bf16 the two differ by the scores' rounding, as the full-row
attention already differs from ``_manual_attention_bf16``; in f32 they
agree to f32 rounding.  A CUDA tensor launches a hand-written kernel of
``csrc/prefix_attention.cu`` (S <= 16, P + S <= 32, else it raises),
chosen by :func:`prefix_route` from the dtype and head_dim alone: bf16 at
head_dim 64 (every shipped text tower) the ``mma.sync`` tensor-core
kernel, which takes 16-byte-aligned views and raises on others; f32, or
another head_dim <= 128, the SIMT kernel.  A CPU tensor runs
:func:`prefix_attention_plain`.  None materializes [B, P, H, d].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scd_tpu_torch.ops import build

SHORT_MAX_L = 256  # the whole-row paths; longer sequences take a long path
LONG_MAX_HD = 256  # head_dim the SIMT long path takes
WGMMA_HD = 64  # head_dim of the tensor-core paths, bf16 and f32, any L
SMEM_MAX = 232_448  # an H100 SM's shared memory a block may opt into
F32_ROWS = 32  # query rows a block of the f32 whole-row SIMT kernel holds

BWD_MAX_HD = 256  # head_dim of the gradient's SIMT route, bf16 and f32


def attention_route(dtype: torch.dtype, hd: int, length: int) -> str:
    """The kernel of ``csrc/attention.cu`` that a CUDA call at ``dtype``,
    head_dim ``hd`` and sequence ``length`` launches: at head_dim 64
    ``"wgmma"`` (bf16, L <= 256), ``"long_wgmma"`` (bf16 past it) or
    ``"f32_wgmma"`` (f32, any L); at another head_dim ``"f32_simt"`` (f32
    at L <= 256 whose K, V, Q and score rows fit in shared memory: the
    whole-row kernel) or ``"long_simt"`` (the key-tiled kernel, head_dim
    <= 256: bf16 at any L, f32 otherwise).  The C entry point decides by
    the same rules."""
    if hd == WGMMA_HD:
        if dtype == torch.float32:
            return "f32_wgmma"
        return "wgmma" if length <= SHORT_MAX_L else "long_wgmma"
    if dtype == torch.float32 and length <= SHORT_MAX_L and 4 * (
            length * (2 * hd + 1) + F32_ROWS * (hd + 1)
            + F32_ROWS * length) <= SMEM_MAX:
        return "f32_simt"
    return "long_simt"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The kernels of ``csrc/attention_bwd.cu`` that a CUDA gradient at
    ``dtype`` and head_dim ``hd`` launches: ``"wgmma"`` (bf16 at head_dim
    64), ``"f32_wgmma"`` (f32 at head_dim 64, three TF32 passes) or
    ``"simt"`` (another head_dim <= 256, bf16 or f32, any L)."""
    if hd == WGMMA_HD:
        return "wgmma" if dtype == torch.bfloat16 else "f32_wgmma"
    return "simt"


def qkv_attention(qkv: torch.Tensor, heads: int, scale: float,
                  causal: bool = False, l_valid: Optional[int] = None
                  ) -> torch.Tensor:
    """Multi-head attention on the packed projection: [B, L, 3W] ->
    [B, L, W] (``qkv_attention_pallas``'s contract; ``l_valid`` defaults
    to L).  Differentiable through :class:`AttentionFunction` when grad
    mode is on and ``qkv`` requires a gradient."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return AttentionFunction.apply(qkv, heads, scale, causal, l_valid)
    return _qkv_attention(qkv, heads, scale, causal, l_valid)


def _heads(qkv: torch.Tensor, heads: int):
    """The q, k, v [B, L, H, d] strided views of a packed [B, L, 3W]."""
    w3 = qkv.shape[-1]
    if w3 % (3 * heads):
        raise ValueError(f"packed width {w3} is not 3 x heads x head_dim "
                         f"(heads={heads})")
    t = qkv.unflatten(-1, (3, heads, w3 // (3 * heads)))
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


def _qkv_attention(qkv, heads, scale, causal, l_valid):
    b, length, w3 = qkv.shape
    q, k, v = _heads(qkv, heads)
    out = vit_attention(q, k, v, scale, causal, l_valid)
    return out.reshape(b, length, w3 // 3)


class AttentionFunction(torch.autograd.Function):
    """:func:`qkv_attention` with a gradient: forward as the dispatch,
    backward :func:`qkv_attention_bwd_cuda` on a CUDA tensor and
    :func:`qkv_attention_bwd_plain` on a CPU one.  Saves the packed qkv
    only; the backward recomputes p.  A CUDA shape the gradient kernel
    does not take raises in the backward, before any update."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, causal, l_valid):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, scale, causal, l_valid)
        return _qkv_attention(qkv, heads, scale, causal, l_valid)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        if qkv.is_cuda:
            dqkv = qkv_attention_bwd_cuda(qkv, dout, *ctx.args)
        else:
            dqkv = qkv_attention_bwd_plain(qkv, dout, *ctx.args)
        return dqkv, None, None, None, None


def qkv_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                            heads: int, scale: float, causal: bool = False,
                            l_valid: Optional[int] = None) -> torch.Tensor:
    """The gradient of :func:`attention_plain` on the packed qkv, by
    autograd, on any device: [B, L, 3W] in qkv's dtype.  The plain
    version of the gradient kernel."""
    b, length, w3 = qkv.shape
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        q, k, v = _heads(x, heads)
        out = attention_plain(q, k, v, scale, causal, l_valid)
        (g,) = torch.autograd.grad(out.reshape(b, length, w3 // 3), x,
                                   dout.reshape(b, length, w3 // 3))
    return g


def _check_bwd(qkv: torch.Tensor, heads: int, causal: bool) -> None:
    """Raise for what the gradient kernels do not take: a qkv that is not
    a bf16 or f32 [B, L, 3W]; L < 1; head_dim > 256; at head_dim 64 (bf16
    or f32) a view whose base or strides are not 16-byte multiples.
    Causal or not, any L, any other head_dim pass (:func:`bwd_route`)."""
    if qkv.dim() != 3 or qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the attention gradient kernel takes a bf16 or f32 "
                        f"[B, L, 3W] qkv, got {qkv.dtype} "
                        f"{tuple(qkv.shape)}")
    length, hd = qkv.shape[1], qkv.shape[2] // (3 * heads)
    if length < 1:
        raise ValueError(f"the attention gradient kernel takes L >= 1, got "
                         f"{length}")
    if not 1 <= hd <= BWD_MAX_HD:
        raise ValueError(f"the attention gradient kernel takes head_dim "
                         f"<= {BWD_MAX_HD}, got {hd}")
    if hd == WGMMA_HD and not _aligned(*_heads(qkv, heads)):
        kind = "bf16" if qkv.dtype == torch.bfloat16 else "f32"
        raise ValueError(f"the {kind} attention gradient kernel at "
                         f"head_dim {WGMMA_HD} takes 16-byte-aligned "
                         f"bases and strides")


def qkv_attention_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor,
                           heads: int, scale: float, causal: bool = False,
                           l_valid: Optional[int] = None) -> torch.Tensor:
    """One launch of ``csrc/attention_bwd.cu`` (two kernels on the current
    stream): the gradient [B, L, 3W] of :func:`qkv_attention` at ``qkv``
    for the output gradient ``dout`` [B, L, W], in qkv's dtype.  Takes
    what :func:`_check_bwd` lets through, on one CUDA device; counts each
    launch in ``qkv_attention_bwd_cuda.launches``, and apart those of the
    f32 ``wgmma`` kernels (``.f32_wgmma_launches``), of the SIMT route
    (``.simt_launches``) and under ``causal`` (``.causal_launches``)."""
    if not (qkv.is_cuda and dout.device == qkv.device):
        raise ValueError("qkv_attention_bwd_cuda takes CUDA tensors on one "
                         "device")
    _check_bwd(qkv, heads, causal)
    b, length, w3 = qkv.shape
    if tuple(dout.shape) != (b, length, w3 // 3):
        raise ValueError(f"dout shape {tuple(dout.shape)} for qkv "
                         f"{tuple(qkv.shape)}")
    l_valid = length if l_valid is None else min(int(l_valid), length)
    if l_valid < 1:
        raise ValueError(f"l_valid must be >= 1, got {l_valid}")
    dqkv = attention_bwd(build.load("attention_bwd"), qkv, dout, heads,
                         scale, l_valid, causal)
    route = bwd_route(qkv.dtype, w3 // (3 * heads))
    qkv_attention_bwd_cuda.launches += 1
    qkv_attention_bwd_cuda.f32_wgmma_launches += route == "f32_wgmma"
    qkv_attention_bwd_cuda.simt_launches += route == "simt"
    qkv_attention_bwd_cuda.causal_launches += bool(causal)
    return dqkv


def attention_bwd(lib: ctypes.CDLL, qkv: torch.Tensor, dout: torch.Tensor,
                  heads: int, scale: float, l_valid: int,
                  causal: bool = False) -> torch.Tensor:
    """One launch of ``lib``'s C entry point ``attention_bwd`` on a
    checked CUDA qkv and its output gradient; raises on a CUDA error.
    Counts nothing."""
    b, length, w3 = qkv.shape
    hd = w3 // (3 * heads)
    dout = dout.to(qkv.dtype).contiguous().view(b, length, heads, hd)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    # row statistics: (max, sum, 1 / sum, D) a row in 64-row tiles at
    # head_dim 64 (the tensor-core kernels), (max, sum, D) planes for the
    # SIMT kernels
    tiles = -(-length // 64)
    stats = torch.empty(4 * b * heads * tiles * 64 if hd == WGMMA_HD
                        else 3 * b * heads * length, dtype=torch.float32,
                        device=qkv.device)
    views = _heads(qkv, heads) + (dout,) + _heads(dqkv, heads)
    strides = [s for t in views for s in _strides(t)]
    fn = lib.attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 21 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        rc = fn(*(t.data_ptr() for t in views[:4]),
                *(t.data_ptr() for t in views[4:]), stats.data_ptr(),
                int(qkv.dtype == torch.bfloat16), *strides, b, heads, length,
                hd, l_valid, int(bool(causal)), float(scale), stream)
    build.check(rc, "attention_bwd")
    return dqkv


qkv_attention_bwd_cuda.launches = 0
qkv_attention_bwd_cuda.f32_wgmma_launches = 0
qkv_attention_bwd_cuda.simt_launches = 0
qkv_attention_bwd_cuda.causal_launches = 0


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool = False,
                  l_valid: Optional[int] = None) -> torch.Tensor:
    """Attention on [B, L, H, d] tensors or views (``vit_attention_pallas``'s
    contract) -> [B, L, H, d] in v's dtype, contiguous.  The dispatch
    point of both entry points."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, L, H, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    length = q.shape[1]
    l_valid = length if l_valid is None else min(int(l_valid), length)
    if l_valid < 1:
        raise ValueError(f"l_valid must be >= 1, got {l_valid}")
    if q.is_cuda:
        return attention_cuda(q, k, v, scale, causal, l_valid)
    if q.device.type != "cpu":
        raise ValueError(f"attention: unsupported device {q.device}")
    return attention_plain(q, k, v, scale, causal, l_valid)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False,
                    l_valid: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device.  Products
    of bf16 values are exact in f32, so f32 matmuls of the upcast inputs
    (TF32 off) give the kernel's scores up to the order of the sums."""
    length = q.shape[1]
    l_valid = length if l_valid is None else min(int(l_valid), length)
    # [B, H, L, L] scores
    s = torch.matmul(q.float().transpose(1, 2),
                     k.float().permute(0, 2, 3, 1)) * scale
    if causal or l_valid < length:
        col = torch.arange(length, device=q.device)
        keep = (col < l_valid)[None, :].expand(length, length)
        if causal:
            keep = keep & (col[None, :] <= col[:, None])
        s.masked_fill_(~keep, float("-inf"))
    e = (s - s.amax(dim=-1, keepdim=True)).exp_()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.matmul(p.float(), v.float().transpose(1, 2))  # [B, H, L, d]
    return out.to(v.dtype).transpose(1, 2).contiguous()


def _strides(t: torch.Tensor):
    sb, sl, sh, sd = t.stride()
    if sd != 1:
        raise ValueError("attention_cuda: the head dimension must be "
                         "contiguous")
    return sb, sl, sh


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool = False,
                   l_valid: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on [B, L, H, d] views (any batch, sequence and
    head strides, the last dimension contiguous), all bf16 or all f32 on
    one CUDA device, by :func:`attention_route`.  d = 64 takes the
    tensor-core paths, with 16-byte-aligned bases and strides (else it
    raises): bf16 the whole-row path at L <= 256 and the ``wgmma`` long
    path past it, f32 the three-pass TF32 kernel at any L.  Another d:
    f32 at L <= 256 whose K, V, Q and score rows fit in shared memory the
    whole-row SIMT kernel; else, bf16 at any L and f32, the key-tiled SIMT
    kernel, d <= 256 (else it raises).  Returns a contiguous [B, L, H, d].
    Counts every launch in ``attention_cuda.launches``, those at L > 256
    also in ``attention_cuda.long_launches``, of those the bf16 ``wgmma``
    long path's also in ``attention_cuda.long_wgmma_launches``, the f32
    kernel's at d = 64 (any L) in ``attention_cuda.f32_wgmma_launches``,
    and the bf16 launches of the SIMT kernel (d != 64, any L) in
    ``attention_cuda.simt_bf16_launches``."""
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError("attention_cuda takes CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"attention_cuda takes all-bf16 or all-f32 inputs, "
                        f"got {q.dtype} / {k.dtype} / {v.dtype}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, length, heads, hd = q.shape
    l_valid = length if l_valid is None else min(int(l_valid), length)
    if l_valid < 1 or length < 1:
        raise ValueError(f"attention_cuda takes L >= 1 and l_valid >= 1 "
                         f"(L={length}, l_valid={l_valid})")
    is_bf16 = q.dtype == torch.bfloat16
    long_path = length > SHORT_MAX_L
    route = attention_route(q.dtype, hd, length)
    wgmma = hd == WGMMA_HD  # the tensor-core paths, bf16 and f32
    if route == "long_simt" and not 1 <= hd <= LONG_MAX_HD:
        raise ValueError(f"the SIMT long attention path takes head_dim <= "
                         f"{LONG_MAX_HD}, got {hd}")
    if wgmma and not _aligned(q, k, v):
        raise ValueError(f"the {'bf16' if is_bf16 else 'f32'} attention "
                         f"kernel at head_dim {WGMMA_HD} takes 16-byte-"
                         f"aligned bases and strides")
    out = attention_fwd(build.load("attention"), q, k, v, scale, causal,
                        l_valid)
    attention_cuda.launches += 1
    attention_cuda.long_launches += long_path
    attention_cuda.long_wgmma_launches += long_path and wgmma and is_bf16
    attention_cuda.f32_wgmma_launches += wgmma and not is_bf16
    attention_cuda.simt_bf16_launches += is_bf16 and not wgmma
    return out


def _aligned(*views: torch.Tensor) -> bool:
    """Every view's base and its batch, sequence and head strides are
    16-byte multiples: what TMA reads."""
    return not any(t.data_ptr() % 16 or any(
        s * t.element_size() % 16 for s in _strides(t)) for t in views)


def attention_fwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, scale: float, causal: bool,
                  l_valid: int) -> torch.Tensor:
    """One launch of ``lib``'s C entry point ``attention_fwd`` on checked
    CUDA views; raises on a CUDA error.  Counts nothing."""
    b, length, heads, hd = q.shape
    out = torch.empty(b, length, heads, hd, dtype=q.dtype, device=q.device)
    fn = lib.attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), *_strides(q), *_strides(k),
                *_strides(v), *out.stride()[:3], b, heads, length, hd,
                l_valid, int(bool(causal)), float(scale), stream)
    build.check(rc, "attention")
    return out


attention_cuda.launches = 0
attention_cuda.long_launches = 0
attention_cuda.long_wgmma_launches = 0
attention_cuda.f32_wgmma_launches = 0
attention_cuda.simt_bf16_launches = 0


PREFIX_MAX_S = 16  # suffix rows the prefix kernels take
PREFIX_MAX_KEYS = 32  # prefix + suffix keys
PREFIX_MAX_HD = 128  # head_dim of the SIMT kernel
PREFIX_MMA_HD = 64  # head_dim of the bf16 tensor-core kernel


def prefix_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel of ``csrc/prefix_attention.cu`` that a CUDA call at
    ``dtype`` and head_dim ``hd`` launches: ``"mma"`` (bf16 at head_dim 64,
    ``mma.sync`` tensor-core tiles) or ``"simt"`` (everything else)."""
    return "mma" if dtype == torch.bfloat16 and hd == PREFIX_MMA_HD \
        else "simt"


def prefix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pk: torch.Tensor, pv: torch.Tensor, scale: float,
                     p_valid: int) -> torch.Tensor:
    """Suffix queries over [cached prefix, own causal] keys (the JAX
    package's ``_prefix_attention`` contract, module docstring): q, k, v
    [B, S, H, d] (views of a packed qkv), pk, pv [P, H, d] shared by the
    batch, ``p_valid`` the real prefix length (keys at or past it are
    masked) -> [B, S, H, d] in v's dtype, contiguous.  A CUDA tensor
    launches the kernel, a CPU one runs the plain version; any other
    device raises."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if pk.dim() != 3 or pk.shape != pv.shape or \
            tuple(pk.shape[1:]) != tuple(q.shape[2:]):
        raise ValueError(f"pk, pv must share one [P, H, d] shape with q's "
                         f"H, d, got {tuple(pk.shape)}, {tuple(pv.shape)} "
                         f"for q {tuple(q.shape)}")
    if q.is_cuda:
        return prefix_attention_cuda(q, k, v, pk, pv, scale, p_valid)
    if q.device.type != "cpu":
        raise ValueError(f"prefix_attention: unsupported device {q.device}")
    return prefix_attention_plain(q, k, v, pk, pv, scale, p_valid)


def prefix_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, scale: float,
                           p_valid: int) -> torch.Tensor:
    """The plain PyTorch version of the prefix kernel, on any device: f32
    products of the upcast inputs (exact for bf16 products; TF32 off),
    the prefix broadcast inside the einsums."""
    n_pre, s_len = pk.shape[0], q.shape[1]
    qf = q.float()
    s_pre = torch.einsum("bshd,phd->bhsp", qf, pk.float()) * scale
    s_pre = s_pre.masked_fill(
        torch.arange(n_pre, device=q.device) >= int(p_valid),
        float("-inf"))
    s_suf = torch.einsum("bshd,bmhd->bhsm", qf, k.float()) * scale
    col = torch.arange(s_len, device=q.device)
    s_suf = s_suf.masked_fill(col[None, :] > col[:, None], float("-inf"))
    s = torch.cat([s_pre, s_suf], dim=-1)  # [B, H, S, P + S]
    e = (s - s.amax(dim=-1, keepdim=True)).exp_()
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    out = torch.einsum("bhsp,phd->bshd", p[..., :n_pre], pv.float()) \
        + torch.einsum("bhsm,bmhd->bshd", p[..., n_pre:], v.float())
    return out.to(v.dtype).contiguous()


def _prefix_vec(*views: torch.Tensor) -> bool:
    """Every view's base, strides and head row allow 16-byte loads."""
    return not any(
        t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16
        or any(s * t.element_size() % 16 for s in t.stride()[:-1])
        for t in views)


def prefix_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pk: torch.Tensor, pv: torch.Tensor, scale: float,
                          p_valid: int) -> torch.Tensor:
    """One launch of ``csrc/prefix_attention.cu`` on CUDA views (any batch,
    row and head strides, the last dimension contiguous), all bf16 or all
    f32 on one device; S <= 16 and P + S <= 32, else it raises.  bf16 at
    head_dim 64 launches the ``mma.sync`` kernel (16-byte-aligned bases
    and strides, else it raises), anything else the SIMT kernel (head_dim
    <= 128, else it raises); :func:`prefix_route` chooses.  It has no
    gradient: a call that would need one raises.  Returns a contiguous
    [B, S, H, d]; counts each launch in ``prefix_attention_cuda.launches``
    and those of the ``mma.sync`` kernel also in ``.mma_launches``."""
    dev = q.device
    views = (q, k, v, pk, pv)
    if not all(t.is_cuda and t.device == dev for t in views):
        raise ValueError("prefix_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype for t in views):
        raise TypeError(f"prefix_attention_cuda takes all-bf16 or all-f32 "
                        f"inputs, got {[str(t.dtype) for t in views]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in views):
        raise NotImplementedError("the prefix attention kernel has no "
                                  "gradient")
    b, s_len, heads, hd = q.shape
    n_pre = pk.shape[0]
    if not (1 <= s_len <= PREFIX_MAX_S and n_pre + s_len <= PREFIX_MAX_KEYS
            and 1 <= hd <= PREFIX_MAX_HD and b >= 1):
        raise ValueError(f"the prefix attention kernel takes S <= "
                         f"{PREFIX_MAX_S}, P + S <= {PREFIX_MAX_KEYS} and "
                         f"head_dim <= {PREFIX_MAX_HD}, got B {b}, S "
                         f"{s_len}, P {n_pre}, head_dim {hd}")
    if any(t.stride(-1) != 1 for t in views):
        raise ValueError("prefix_attention_cuda: the head dimension must be "
                         "contiguous")
    mma = prefix_route(q.dtype, hd) == "mma"
    if mma and not _prefix_vec(*views):
        raise ValueError(f"the bf16 prefix attention kernel at head_dim "
                         f"{PREFIX_MMA_HD} takes 16-byte-aligned bases and "
                         f"strides")
    out = prefix_attention_fwd(build.load("prefix_attention"), q, k, v, pk,
                               pv, scale, p_valid, mma)
    prefix_attention_cuda.launches += 1
    prefix_attention_cuda.mma_launches += mma
    return out


def prefix_attention_fwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                         scale: float, p_valid: int, mma: bool
                         ) -> torch.Tensor:
    """One launch of ``lib``'s C entry point ``prefix_attention_mma_fwd``
    (``mma``) or ``prefix_attention_fwd`` (the SIMT kernel) on checked CUDA
    views; raises on a CUDA error.  Counts nothing."""
    b, s_len, heads, hd = q.shape
    n_pre = pk.shape[0]
    out = torch.empty(b, s_len, heads, hd, dtype=q.dtype, device=q.device)
    if mma:
        fn, is_bf16, vec = lib.prefix_attention_mma_fwd, [], []
    else:  # the SIMT entry also takes the dtype and the 16-byte-load flag
        fn = lib.prefix_attention_fwd
        is_bf16 = [int(q.dtype == torch.bfloat16)]
        vec = [int(_prefix_vec(q, k, v, pk, pv))]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * len(is_bf16)
                   + [ctypes.c_longlong] * 16 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * len(vec)
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*(t.data_ptr() for t in (q, k, v, pk, pv)), out.data_ptr(),
                *is_bf16, *_strides(q), *_strides(k), *_strides(v),
                *pk.stride()[:2], *pv.stride()[:2], *out.stride()[:3], b,
                heads, s_len, n_pre, hd, max(0, min(int(p_valid), n_pre)),
                float(scale), *vec, stream)
    build.check(rc, "prefix_attention")
    return out


prefix_attention_cuda.launches = 0
prefix_attention_cuda.mma_launches = 0
