"""The attention gradient kernel on the card, against another build.

    python -m scd_tpu_torch.testing.attention_bwd [--against SRC.cu]

At a GCD training step's shapes (B 256, H 12, d 64, bf16, the packed qkv
as the trainable block gives it): L 197 (image 224), L 208 with l_valid
197 (the sequence ``--int8_frozen`` pads) and L 257 (image 256).  Times
this tree's kernel (``ops.attention.qkv_attention_bwd_cuda``), its plain
version (autograd of ``attention_plain``), the backward of
``F.scaled_dot_product_attention`` by autograd (a yardstick, used nowhere
in the port) and the least time the card could take (q, k, v and dO read
and dq, dk, dv written once at 3.35 TB/s; the five products of a gradient
over the kept score pairs at 989 TFLOP/s bf16).  With ``--against``, the
same C entry point built from another source with ``ops/build.py``'s
flags (for example the parent commit's ``csrc/attention_bwd.cu``) is
timed in turns, other, this, this, other, on the same inputs, with the
max abs difference of the two gradients.  Times with CUDA events; prints
the card's name and power limit first.  ``chip_smoke.py`` phase 5 runs
:func:`time_shapes`, also in f32 at B 128 and 64 · L 197 and B 128 · L
257 (the end-to-end baselines' shapes: the f32 kernels at head_dim 64,
bounded at 4-byte elements and three TF32 passes).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

PEAK_BF16_FLOPS, PEAK_TF32_FLOPS = 989e12, 495e12
PEAK_F32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
B, H, D = 256, 12, 64
SHAPES = (("train", 197, 197), ("train-int8-pad", 208, 197),
          ("image-256", 257, 257))  # (tag, L, l_valid)


def bound_ms(b: int, length: int, h: int, d: int, l_valid: int,
             f32: bool = False, causal: bool = False) -> tuple:
    """(least ms, what bounds it): q, k, v and dO read once, dq, dk, dv
    written once; the five products a gradient needs (s = q . k^T again,
    dP = dO . V^T, dV = P^T . dO, dQ = dS . K, dK = dS^T . Q) over the
    score pairs this input keeps (keys < l_valid; under ``causal`` none
    after its query): bf16 at the bf16 peak; f32 (4-byte elements) as
    three TF32 passes at the TF32 peak, the route of the f32 kernels at
    head_dim 64."""
    pairs = (sum(min(r + 1, l_valid) for r in range(length)) if causal
             else length * l_valid)
    flops = 10.0 * b * h * d * pairs
    t_ops = 3 * flops / PEAK_TF32_FLOPS if f32 else flops / PEAK_BF16_FLOPS
    t_bytes = 7.0 * (4 if f32 else 2) * b * length * h * d / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_other(src: str) -> ctypes.CDLL:
    """``src`` (an ``attention_bwd.cu``) built with ``ops/build.py``'s
    flags into a temporary directory, loaded."""
    from scd_tpu_torch.ops import build

    out = os.path.join(tempfile.mkdtemp(), "libattention_bwd_other.so")
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"building {src} failed:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(out)


def time_shapes(gen, other=None, shapes=SHAPES, reps: int = 10,
                b: int = B, dtype=None) -> dict:
    """{tag: (kernel ms, plain ms, SDPA backward ms, bound ms, bound by,
    other ms or None)} at ``shapes``, batch ``b``, ``dtype`` (default
    bf16; f32 takes the three-pass TF32 kernels), one line printed per shape;
    ``other`` a library from :func:`build_other`."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    out = {}
    for tag, length, lv in shapes:
        qkv = torch.randn(b, length, 3 * H * D, generator=gen,
                          device="cuda").to(dtype)
        dout = torch.randn(b, length, H * D, generator=gen,
                           device="cuda").to(dtype)
        scale = D ** -0.5

        def kern():
            return A.qkv_attention_bwd_cuda(qkv, dout, H, scale, False, lv)

        line = (f"  attention_bwd {tag} B={b} L={length} l_valid={lv} H={H} "
                f"d={D} {'f32' if f32 else 'bf16'}:")
        t_other = None
        if other is not None:
            def then():
                return A.attention_bwd(other, qkv, dout, H, scale, lv)

            try:
                diff = (then().float() - kern().float()).abs().max().item()
            except RuntimeError:  # a launch the other build refuses
                other_takes = False
                line += " the other build refuses this shape;"
            else:
                other_takes = True
        if other is not None and other_takes:
            t_other = _ms(then, reps)
            ms = _ms(kern, reps)
            again = _ms(kern, reps)
            t_other2 = _ms(then, reps)
            line += (f" kernel {ms:.4f} ms (again {again:.4f}), other build "
                     f"{t_other:.4f} ms (again {t_other2:.4f}), max |kernel -"
                     f" other| {diff:.3e};")
        if t_other is None:
            ms = _ms(kern, reps)
            line += f" kernel {ms:.4f} ms (again {_ms(kern, reps):.4f});"
        plain = _ms(lambda: A.qkv_attention_bwd_plain(
            qkv, dout, H, scale, False, lv), max(2, reps // 5))
        q, k, v = (t.transpose(1, 2).detach().requires_grad_(True)
                   for t in A._heads(qkv, H))
        mask = None
        if lv < length:
            mask = (torch.arange(length, device="cuda") < lv)[
                None, None, None, :]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        go = dout.view(b, length, H, D).transpose(1, 2)
        lib = _ms(lambda: torch.autograd.grad(o, (q, k, v), go,
                                              retain_graph=True), reps)
        bound, by = bound_ms(b, length, H, D, lv, f32)
        simt = ""
        if f32:  # the same products at the f32 rate outside the tensor cores
            t_simt = max(10.0 * b * H * D * length * lv / PEAK_F32_FLOPS,
                         28.0 * b * length * H * D / PEAK_HBM_BYTES)
            simt = f"; f32 SIMT bound {t_simt * 1e3:.4f} ms"
        print(f"{line} plain {plain:.4f} ms, library (SDPA backward) "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by}{simt}); "
              f"{ms / bound:.1f} x the bound, {ms / lib:.2f} x SDPA's "
              f"backward", flush=True)
        out[tag] = (ms, plain, lib, bound, by, t_other)
        del qkv, dout, q, k, v, o, go
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", default=None,
                   help="an attention_bwd.cu to build and time beside")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    other = build_other(args.against) if args.against else None
    time_shapes(torch.Generator(device="cuda").manual_seed(0), other)


if __name__ == "__main__":
    main()
