"""W8A8 dense layers: int8 activations x int8 weights, int32 accumulation.

Port of the three W8A8 TPU kernels of ``scd_tpu/ops/pallas_kernels.py``
(``dense_w8a8_fusedq_pallas``, ``dense_w8a8_pallas``,
``dense_w8a8_pallas_3d``).  Two kernels written by hand in CUDA C++
(``csrc/w8a8.cu``) take their place:

- ``w8a8_fusedq``: bf16 x is quantized per row inside the kernel, then
  multiplied, dequantized, biased, activated and cast
  (:func:`dense_w8a8_fusedq`);
- ``w8a8_prequant``: x arrives as int8 with its row scales
  (:func:`dense_w8a8`, and :func:`dense_w8a8_3d`, whose contiguous
  ``[B, L, D]`` input is the ``[B*L, D]`` matrix, so the same kernel serves
  it).

Dispatch by device: a CUDA tensor launches the kernel (or raises on
anything the kernel does not take); a CPU tensor runs the plain version
beside it.  There is no fallback from the kernel to the plain version.

Weights are prepared once (:func:`prepare_weight`) into the kernel's
layout: ``wq_t`` int8 ``[F, D]`` (the ``[D, F]`` kernel transposed, so both
operands are contiguous along D) and per-output-channel scales ``s_w``
``[F]``.  The plain versions take the same arguments.  Their int8 products
are exact (f32 while 127^2 * D < 2^24, float64 beyond), then round to f32
as the kernel's int32 -> f32 conversion does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scd_tpu_torch.ops import build

ACTS = {None: 0, "quick_gelu": 1, "gelu_tanh": 2, "gelu": 3}
PANEL_MAX_D = 1536  # the widest D w8a8_fusedq takes (csrc/w8a8.cu)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` by IEEE division.  The divisor is a
    tensor on ``amax``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, and 1/127 is inexact, so
    a scale could differ by one ulp and flip a rounding at a quantization
    boundary."""
    return amax.clamp_min(1e-12) / torch.full((), 127.0, device=amax.device)


def prepare_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel`` [D, F] -> (``wq_t`` int8 [F, D], ``s_w`` f32 [F]):
    symmetric per-output-channel quantization, ``s_w = max(amax, 1e-12) /
    127`` and ``wq = round(w / s_w)`` (half to even), as ``Int8Dense``."""
    w32 = kernel.detach().float()
    s_w = _scale(w32.abs().amax(dim=0))
    wq = torch.round(w32 / s_w).to(torch.int8)
    return wq.t().contiguous(), s_w.contiguous()


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric quantization of ``x`` at f32:
    (``xq`` int8, ``s_x`` f32 with a trailing axis of 1).  The plain chain
    of ``Int8Dense``: IEEE division, clamp, round half to even."""
    x32 = x.float()
    s_x = _scale(x32.abs().amax(dim=-1, keepdim=True))
    xq = torch.round(torch.clamp(x32 / s_x, -127.0, 127.0)).to(torch.int8)
    return xq, s_x


def act_plain(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The epilogue activations (``_w8a8_act``), at ``y``'s dtype."""
    if act == "quick_gelu":
        return y * torch.sigmoid(1.702 * y)
    if act == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if act == "gelu":
        return F.gelu(y)
    if act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y


def _int8_product(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """Exact int8 [N, D] @ ([F, D] int8).T as f32.  Every partial sum is an
    integer below 127^2 * D, exact in f32 while that is below 2^24
    (D <= 1040) and in float64 at any D; the f64 result is then rounded
    once to f32, like the kernel's int32 -> f32 conversion.  On a card the
    product stays in float64, whatever the process's TF32 setting."""
    if xq.device.type == "cpu" and 127 * 127 * xq.shape[-1] < 2 ** 24:
        return torch.matmul(xq.float(), wq_t.float().t())
    return torch.matmul(xq.double(), wq_t.double().t()).float()


def dense_w8a8_plain(xq: torch.Tensor, wq_t: torch.Tensor, s_x: torch.Tensor,
                     s_w: torch.Tensor, bias: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of ``w8a8_prequant``: xq [N, D] int8, s_x [N] or
    [N, 1] -> ``((acc * s_x) * s_w + b)`` cast to ``out_dtype``."""
    y = _int8_product(xq, wq_t) * s_x.reshape(-1, 1).float() * s_w.reshape(
        1, -1).float() + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def dense_w8a8_fusedq_plain(x: torch.Tensor, wq_t: torch.Tensor,
                            s_w: torch.Tensor, bias: torch.Tensor,
                            out_dtype=torch.bfloat16,
                            act: Optional[str] = None) -> torch.Tensor:
    """The plain version of ``w8a8_fusedq``: quantize x [N, D] per row,
    the int8 product, dequant and bias at f32, the activation at f32, then
    the cast."""
    xq, s_x = quantize_rows(x)
    y = dense_w8a8_plain(xq, wq_t, s_x, s_w, bias, torch.float32)
    return act_plain(y, act).to(out_dtype)


# ----------------------------------------------------------- dispatch


def dense_w8a8_fusedq(x: torch.Tensor, wq_t: torch.Tensor, s_w: torch.Tensor,
                      bias: torch.Tensor, out_dtype=torch.bfloat16,
                      act: Optional[str] = None) -> torch.Tensor:
    """x [N, D] -> [N, F]: the kernel on a CUDA tensor (x must be bf16, as
    the TPU path feeds it), the plain version on a CPU tensor."""
    if x.is_cuda:
        return w8a8_fusedq_cuda(x, wq_t, s_w, bias, out_dtype, act)
    _cpu_only(x, "dense_w8a8_fusedq")
    return dense_w8a8_fusedq_plain(x, wq_t, s_w, bias, out_dtype, act)


def dense_w8a8(xq: torch.Tensor, wq_t: torch.Tensor, s_x: torch.Tensor,
               s_w: torch.Tensor, bias: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Pre-quantized xq [N, D] int8 with s_x [N, 1] -> [N, F]."""
    if xq.is_cuda:
        return w8a8_prequant_cuda(xq, s_x, wq_t, s_w, bias, out_dtype)
    _cpu_only(xq, "dense_w8a8")
    return dense_w8a8_plain(xq, wq_t, s_x, s_w, bias, out_dtype)


def dense_w8a8_3d(xq: torch.Tensor, wq_t: torch.Tensor, s_x: torch.Tensor,
                  s_w: torch.Tensor, bias: torch.Tensor,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Rank-3 form: xq [B, L, D] int8 with s_x [B, L, 1] -> [B, L, F].  A
    contiguous [B, L, D] tensor is the [B*L, D] matrix, so this is
    :func:`dense_w8a8` on that view."""
    if xq.dim() != 3:
        raise ValueError(f"dense_w8a8_3d takes [B, L, D], got "
                         f"{tuple(xq.shape)}")
    b, length, d = xq.shape
    y = dense_w8a8(xq.reshape(b * length, d), wq_t, s_x.reshape(b * length, 1),
                   s_w, bias, out_dtype)
    return y.reshape(b, length, -1)


def _cpu_only(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")


# ----------------------------------------------------------- kernels


def _check_common(what: str, x: torch.Tensor, wq_t: torch.Tensor,
                  s_w: torch.Tensor, bias: torch.Tensor, out_dtype) -> None:
    tensors = (x, wq_t, s_w, bias)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if wq_t.dtype != torch.int8 or s_w.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise TypeError(f"{what}: wq_t int8, s_w and bias f32 (got "
                        f"{wq_t.dtype}, {s_w.dtype}, {bias.dtype})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: out_dtype bf16 or f32, got {out_dtype}")
    if x.dim() != 2 or wq_t.dim() != 2 or x.shape[1] != wq_t.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and wq_t "
                         f"{tuple(wq_t.shape)} do not chain ([N, D], [F, D])")
    f = wq_t.shape[0]
    if s_w.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"{what}: s_w and bias must be [{f}]")
    if x.shape[1] % 16:
        raise ValueError(f"{what}: D must be a multiple of 16, got "
                         f"{x.shape[1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, wq_t)):
        raise ValueError(f"{what}: x and wq_t must be 16-byte aligned")


def _lib_fn(name: str, argtypes):
    fn = getattr(build.load("w8a8"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _panel_tiles(n: int, d: int, f: int, device) -> int:
    """Column tiles (of 128) per block of ``w8a8_fusedq``, which runs one
    block per SM: all of them when there are enough 128-row panels to
    fill the card four times over, else fewer, so that the blocks still
    make about four waves (F split between blocks that each quantize the
    same panel; at the ViT qkv shape 3 x 208 blocks)."""
    rows, nt = -(-n // 128), -(-f // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = min(max(-(-4 * sms // rows), 1), max(nt // 4, 1))
    return -(-nt // groups)


def w8a8_fusedq_cuda(x: torch.Tensor, wq_t: torch.Tensor, s_w: torch.Tensor,
                     bias: torch.Tensor, out_dtype=torch.bfloat16,
                     act: Optional[str] = None) -> torch.Tensor:
    """Launch ``w8a8_fusedq``: x [N, D] bf16, wq_t [F, D] int8, s_w and
    bias [F] f32, all contiguous on one CUDA device, D % 16 == 0 and
    D <= ``PANEL_MAX_D`` (each block quantizes its rows once into shared
    memory).  Returns [N, F] of ``out_dtype`` (bf16 or f32).  Counts its
    launches in ``w8a8_fusedq_cuda.launches``."""
    _check_common("w8a8_fusedq", x, wq_t, s_w, bias, out_dtype)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"w8a8_fusedq takes bf16 x, got {x.dtype}")
    if act not in ACTS:
        raise ValueError(f"w8a8_fusedq: unknown activation {act!r}")
    n, d = x.shape
    f = wq_t.shape[0]
    if d > PANEL_MAX_D:
        raise ValueError(f"w8a8_fusedq takes D <= {PANEL_MAX_D}, got {d}")
    tiles = _panel_tiles(n, d, f, x.device)
    out = torch.empty(n, f, dtype=out_dtype, device=x.device)
    fn = _lib_fn("w8a8_fusedq", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wq_t.data_ptr(), s_w.data_ptr(),
                bias.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), ACTS[act], n, d, f, tiles,
                stream)
    build.check(rc, "w8a8_fusedq")
    w8a8_fusedq_cuda.launches += 1
    return out


w8a8_fusedq_cuda.launches = 0


def w8a8_prequant_cuda(xq: torch.Tensor, s_x: torch.Tensor,
                       wq_t: torch.Tensor, s_w: torch.Tensor,
                       bias: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch ``w8a8_prequant``: xq [N, D] int8 with s_x [N] or [N, 1] f32,
    the rest as :func:`w8a8_fusedq_cuda`, at any D % 16 == 0 (no panel
    limit: both operands stream through the kernel).  Counts its launches
    in ``w8a8_prequant_cuda.launches``."""
    _check_common("w8a8_prequant", xq, wq_t, s_w, bias, out_dtype)
    n, d = xq.shape
    if xq.dtype != torch.int8:
        raise TypeError(f"w8a8_prequant takes int8 xq, got {xq.dtype}")
    if not (s_x.is_cuda and s_x.device == xq.device
            and s_x.dtype == torch.float32 and s_x.numel() == n
            and s_x.is_contiguous()):
        raise ValueError("w8a8_prequant: s_x must be a contiguous f32 [N] "
                         "tensor on xq's device")
    f = wq_t.shape[0]
    out = torch.empty(n, f, dtype=out_dtype, device=xq.device)
    fn = _lib_fn("w8a8_prequant", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _P])
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    with torch.cuda.device(xq.device):
        rc = fn(xq.data_ptr(), s_x.data_ptr(), wq_t.data_ptr(),
                s_w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), n, d, f, stream)
    build.check(rc, "w8a8_prequant")
    w8a8_prequant_cuda.launches += 1
    return out


w8a8_prequant_cuda.launches = 0
