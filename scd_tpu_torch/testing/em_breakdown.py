"""Where the fused EM kernels' time goes, on the card.

    python -m scd_tpu_torch.testing.em_breakdown [--n N --d D --k K]

Times each part of one ``fused_em_step`` call (``csrc/fused_em.cu``) at
the main path's shape (N = 97,536, D = 768, K = 100, or the shape given),
with bf16 and with f32 x: the split pre-pass, the E-step, the M-step, the finalize, and all
four together.  Each part runs through ``ops.em.fused_em_launch(phases=...)``
on the scratch of a whole call, captured once in a CUDA graph and replayed,
so the host's time per call (Python, tensor maps, launches) is not in the
device times; a whole call launched directly is printed beside them.
Times with CUDA events; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess

PARTS = (("split", 1), ("E-step", 2), ("M-step", 4), ("finalize", 8),
         ("all", 15))


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


def _graph(fn):
    """``fn`` captured in a CUDA graph (after one warm call on a side
    stream, as capture asks)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def main(n: int = 97_536, d: int = 768, k: int = 100, reps: int = 50) -> None:
    import torch

    from scd_tpu_torch.core.device import f32_matmuls
    from scd_tpu_torch.ops.em import fused_em_launch, fused_em_step_cuda

    if not torch.cuda.is_available():
        raise SystemExit("em_breakdown needs a CUDA device")
    f32_matmuls()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cls = 3.0 * torch.randn(k, d, generator=gen, device="cuda")
    lab = torch.randint(0, k, (n,), generator=gen, device="cuda")
    x = cls[lab] + 0.5 * torch.randn(n, d, generator=gen, device="cuda")
    x = (x / x.norm(dim=1, keepdim=True)).contiguous()
    c = x[torch.linspace(0, n - 1, k, device="cuda").round().long()]
    for xk in (x.to(torch.bfloat16), x):
        work = fused_em_launch(xk, c)[4]
        times = []
        for name, phases in PARTS:
            graph = _graph(lambda: fused_em_launch(xk, c, phases=phases,
                                                   work=work))
            times.append(f"{name} {_ms(graph.replay, reps):.4f}")
        direct = _ms(lambda: fused_em_step_cuda(xk, c), reps)
        print(f"fused_em N={n} D={d} K={k} x={str(xk.dtype)[6:]}: device "
              f"ms (graph replay) {', '.join(times)}; launched directly "
              f"{direct:.4f} ms")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=97_536)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--k", type=int, default=100)
    a = p.parse_args()
    main(a.n, a.d, a.k)
