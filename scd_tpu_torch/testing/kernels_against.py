"""``w8a8_prequant`` and ``estep_assign`` on the card, against other builds.

    python -m scd_tpu_torch.testing.kernels_against \
        [--w8a8 OTHER_w8a8.cu] [--estep OTHER_estep.cu] [--only w8a8|estep]

Times this tree's kernels at the shapes their callers give them:
``w8a8_prequant`` (``ops.w8a8.w8a8_prequant_cuda``, bf16 out) at the
unpadded ViT-B/16 tower's qkv and fc1 layers (N 25,216 = 128 images x
L 197, D 768, F 2,304 / 3,072) and at D 3,072 · F 768 (a layer wider than
``w8a8_fusedq`` takes); ``estep_assign`` (``ops.distance.estep_assign``)
at the k-means runners' shape (N 130,048, D 768, K 100, f32).  Beside
each: the least time the card could take (operations at the int8 or
bf16 tensor-core peak, bytes at 3.35 TB/s; for the estep, three bf16
passes of the f32 product).  With ``--w8a8`` or ``--estep``, the same C
entry point built from another source with ``ops/build.py``'s flags (for
example the parent commit's, unpacked with ``git archive``) is timed in
turns, other, this, this, other, on the same inputs, and the outputs are
compared (W8A8: equal bits; estep: label mismatches and the max min-
distance difference).  An ``estep.cu`` whose entry point is
``estep_assign_f32`` (the SIMT kernel's) is called with that function's
arguments (x, c, n, d, k, labels, mindist, csq [k], stream); one with
``estep_assign`` through ``ops.distance._launch``.  Times with CUDA events;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile

PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 1979e12, 989e12, 3.35e12
W8A8_SHAPES = (("vit-qkv-L197", 25_216, 768, 2_304),
               ("vit-fc1-L197", 25_216, 768, 3_072),
               ("d3072", 25_216, 3_072, 768))
ESTEP_SHAPE = (130_048, 768, 100)


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


def _build(src: str, name: str) -> ctypes.CDLL:
    from scd_tpu_torch.ops import build

    out = os.path.join(tempfile.mkdtemp(), f"lib{name}_other.so")
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"building {src} failed:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(out)


def _turns(other, this, reps):
    """'kernel t (again t2), other o (again o2)' timed other, this, this,
    other; or the kernel alone."""
    if other is None:
        return (f"kernel {_ms(this, reps):.4f} ms (again "
                f"{_ms(this, reps):.4f})")
    t_other = _ms(other, reps)
    t_this, t_this2 = _ms(this, reps), _ms(this, reps)
    t_other2 = _ms(other, reps)
    return (f"kernel {t_this:.4f} ms (again {t_this2:.4f}), other "
            f"{t_other:.4f} ms (again {t_other2:.4f})")


def w8a8(other_src, gen, reps: int = 20) -> None:
    import torch

    from scd_tpu_torch.ops import build, w8a8 as W

    other = _build(other_src, "w8a8") if other_src else None
    if other is not None:
        fn = other.w8a8_prequant
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    for tag, n, d, f in W8A8_SHAPES:
        x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
        wq_t, s_w = W.prepare_weight(
            0.02 * torch.randn(d, f, generator=gen, device="cuda"))
        bias = 0.1 * torch.randn(f, generator=gen, device="cuda")
        xq, s_x = W.quantize_rows(x)

        def this():
            return W.w8a8_prequant_cuda(xq, s_x, wq_t, s_w, bias)

        then = None
        line = f"w8a8_prequant {tag} N={n} D={d} F={f} bf16:"
        if other is not None:
            out = torch.empty(n, f, dtype=torch.bfloat16, device="cuda")

            def then():
                build.check(fn(xq.data_ptr(), s_x.data_ptr(), wq_t.data_ptr(),
                               s_w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                               1, n, d, f,
                               torch.cuda.current_stream().cuda_stream),
                            "other w8a8_prequant")
                return out

            same = torch.equal(then(), this())
            line += f" bits equal to other: {same};"
        ops = 2.0 * n * d * f
        nbytes = n * d + d * f + 8.0 * f + 4.0 * n + 2.0 * n * f
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
        line += (f" {_turns(then, this, reps)}; bound "
                 f"{max(t_ops, t_bytes) * 1e3:.4f} ms "
                 f"({'operations' if t_ops >= t_bytes else 'bytes'})")
        print(line, flush=True)
        del x, xq, s_x, wq_t, s_w, bias


def estep(other_src, gen, reps: int = 20) -> None:
    import torch

    from scd_tpu_torch.ops import build, distance as D

    other = _build(other_src, "estep") if other_src else None
    n, d, k = ESTEP_SHAPE
    cls = 3.0 * torch.randn(k, d, generator=gen, device="cuda")
    lab = torch.randint(0, k, (n,), generator=gen, device="cuda")
    x = cls[lab] + 0.5 * torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=1, keepdim=True)).contiguous()
    c = x[torch.linspace(0, n - 1, k, device="cuda").round().long()]
    c = c.contiguous()

    def this():
        return D.estep_assign(x, c)

    then = None
    line = f"estep_assign N={n} D={d} K={k} f32:"
    if other is not None:
        labels = torch.empty(n, dtype=torch.int32, device="cuda")
        mindist = torch.empty(n, device="cuda")
        if hasattr(other, "estep_assign"):  # this tree's arguments
            def then():
                D._launch(other, x, c, labels, mindist)
                return labels, mindist
        else:
            fn = other.estep_assign_f32
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 4)
            csq = torch.empty(k, device="cuda")

            def then():
                build.check(fn(x.data_ptr(), c.data_ptr(), n, d, k,
                               labels.data_ptr(), mindist.data_ptr(),
                               csq.data_ptr(),
                               torch.cuda.current_stream().cuda_stream),
                            "other estep_assign")
                return labels, mindist

        (la, ma), (lb, mb) = then(), this()
        line += (f" label mismatches with other "
                 f"{int((la != lb).sum())}, max |mindist - other| "
                 f"{(ma - mb).abs().max().item():.3e};")
    flops = 2.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d) + 8.0 * n
    t_ops, t_bytes = 3 * flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    line += (f" {_turns(then, this, reps)}; bound "
             f"{max(t_ops, t_bytes) * 1e3:.4f} ms "
             f"({'operations' if t_ops >= t_bytes else 'bytes'}; three bf16 "
             f"passes)")
    print(line, flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--w8a8", default=None,
                   help="a w8a8.cu to build and time beside")
    p.add_argument("--estep", default=None,
                   help="an estep.cu to build and time beside")
    p.add_argument("--only", choices=("w8a8", "estep"), default=None)
    args = p.parse_args(argv)

    import torch

    from scd_tpu_torch.core.device import f32_matmuls

    if not torch.cuda.is_available():
        raise SystemExit("kernels_against needs a CUDA device")
    f32_matmuls()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.only in (None, "w8a8"):
        w8a8(args.w8a8, gen)
    if args.only in (None, "estep"):
        estep(args.estep, gen)


if __name__ == "__main__":
    main()
