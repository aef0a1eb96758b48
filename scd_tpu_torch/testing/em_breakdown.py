"""Where the fused EM kernel's time goes, on the card.

    python -m scd_tpu_torch.testing.em_breakdown

Builds ``csrc/fused_em.cu`` as it is and two variants cut from it — one
without the M-step (sort, segment sums, slab updates), one without the
E-step's products (the SGEMM's FMAs) — and times each at the main path's
shape (N = 97,536, D = 768, K = 100) with CUDA events, f32 and bf16 x.
The variants compute wrong results; only their times mean anything.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile


def _variants(src: str):
    m0 = src.index("    // ---- stable sort of the tile's rows")
    m1 = src.index("    // ---- inertia of the tile")
    fma = "acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);"
    return {"full": src,
            "no M-step": src[:m0] + src[m1:],
            "no E-step FMAs": src.replace(fma, "acc[p][q] += a[p] * (q == 0 ? bb[q] : 0.f);")}


def main(n: int = 97_536, d: int = 768, k: int = 100) -> None:
    import torch

    from scd_tpu_torch.core.device import f32_matmuls
    from scd_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("em_breakdown needs a CUDA device")
    f32_matmuls()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    with open(os.path.join(build.CSRC, "fused_em.cu")) as f:
        variants = _variants(f.read())
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, text) in enumerate(variants.items()):
            path = os.path.join(tmp, f"v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            procs[name] = (subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so",
                 path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), path[:-3] + ".so")
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{log}")
            libs[name] = ctypes.CDLL(so)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cls = 3.0 * torch.randn(k, d, generator=gen, device="cuda")
    lab = torch.randint(0, k, (n,), generator=gen, device="cuda")
    x = cls[lab] + 0.5 * torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=1, keepdim=True)).contiguous()
    c = x[torch.linspace(0, n - 1, k, device="cuda").round().long()]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = max(1, min(-(-n // 128), 2 * sms))
    f32 = dict(dtype=torch.float32, device="cuda")
    bufs = [torch.empty(n, dtype=torch.int32, device="cuda"),
            torch.empty(k, d, **f32), torch.empty(k, **f32),
            torch.empty((), **f32), torch.empty(k, **f32),
            torch.empty(grid, k, d, **f32), torch.empty(grid, k, **f32),
            torch.empty(grid, **f32)]
    for xk in (x, x.to(torch.bfloat16)):
        for name, lib in libs.items():
            fn = lib.fused_em_step
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * 9)

            def run():
                rc = fn(xk.data_ptr(), int(xk.dtype == torch.bfloat16),
                        c.data_ptr(), None, n, d, k, grid,
                        *[t.data_ptr() for t in bufs],
                        torch.cuda.current_stream().cuda_stream)
                build.check(rc, name)

            for _ in range(3):
                run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(30):
                run()
            stop.record()
            torch.cuda.synchronize()
            print(f"fused_em N={n} D={d} K={k} x={str(xk.dtype)[6:]} "
                  f"{name}: {start.elapsed_time(stop) / 30:.4f} ms")


if __name__ == "__main__":
    main()
