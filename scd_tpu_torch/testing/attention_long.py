"""Attention's bf16 long path (L > 256) on the card, against another build.

    python -m scd_tpu_torch.testing.attention_long [--against SRC.cu]

At the ViT-B/16 tower's long shapes (B 128, H 12, d 64, the packed qkv
projection as the tower gives it): L 257, 325, 577 and 785 (image 256,
288, 384 and 448).  Times this tree's kernel
(``ops.attention.qkv_attention``), ``F.scaled_dot_product_attention`` (a
yardstick, used nowhere in the port) and the least time the card could
take (q, k, v read and the output written once at 3.35 TB/s; q . k and
p . v at 989 TFLOP/s bf16).  With
``--against``, the same C entry point built from another source with
``ops/build.py``'s flags (for example the parent commit's
``csrc/attention.cu``) is timed in turns, other, this, this, other, on the
same inputs, with the max abs difference of the two outputs.  Times with
CUDA events; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
SHAPES = ((257, 256), (325, 288), (577, 384), (785, 448))  # (L, image px)


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
    """``src`` (an ``attention.cu``) built with ``ops/build.py``'s flags
    into a temporary directory, loaded."""
    from scd_tpu_torch.ops import build

    out = os.path.join(tempfile.mkdtemp(), "libattention_other.so")
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"building {src} failed:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(out)


def bound_ms(b: int, length: int, h: int, d: int) -> tuple:
    """(least ms, what bounds it) of non-causal bf16 attention."""
    t_ops = 4.0 * b * h * d * length * length / PEAK_BF16_FLOPS
    t_bytes = 4.0 * 2 * b * length * h * d / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", default=None,
                   help="an attention.cu to build and time beside")
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("attention_long needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    other = build_other(args.against) if args.against else None
    b, h, d, reps = 128, 12, 64, 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    for length, px in SHAPES:
        qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                          device="cuda").to(torch.bfloat16)
        t = qkv.unflatten(-1, (3, h, d))
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def this():
            return A.qkv_attention(qkv, h, d ** -0.5)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt)

        line = (f"attention long L={length} (image {px}) B={b} H={h} d={d}"
                f" bf16:")
        if other is not None:
            def then():
                return A.attention_fwd(other, q, k, v, d ** -0.5, False,
                                       length)

            diff = (then().float() - this().reshape(b, length, h, d)
                    .float()).abs().max().item()
            t_other = _ms(then, reps)
            t_this = _ms(this, reps)
            t_this2 = _ms(this, reps)
            t_other2 = _ms(then, reps)
            line += (f" kernel {t_this:.4f} ms (again {t_this2:.4f}), other"
                     f" {t_other:.4f} ms (again {t_other2:.4f}), max "
                     f"|kernel - other| {diff:.3e};")
        else:
            line += (f" kernel {_ms(this, reps):.4f} ms (again "
                     f"{_ms(this, reps):.4f});")
        bound, by = bound_ms(b, length, h, d)
        line += (f" SDPA {_ms(lib, reps):.4f} ms, bound {bound:.4f} "
                 f"ms ({by})")
        print(line, flush=True)
        del qkv, q, k, v, qt, kt, vt, t


if __name__ == "__main__":
    main()
