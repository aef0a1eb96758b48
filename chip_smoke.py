#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:

1. device and build: the card's name and power limit (``nvidia-smi``),
   then both CUDA kernels built from ``scd_tpu_torch/csrc`` (one ``nvcc``
   per source, started together) with the compiler's register report;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge shapes, with the stated
   tolerances; the fused EM kernel must also repeat its bits exactly;
3. the main path: an ImageNet-100-scale root fabricated from ``--seed``
   (N = 130,048 images, 768-d / 512-d features, V = 68,000 nouns) and
   ``scd_tpu_torch.pipelines.unsup.run_unsup`` with SSKM, K = 100,
   n_init = 10, max_iterations = 10, with every kernel's launch count set
   to 0 just before and read just after; ACC and IoU must clear floors,
   and on a small root the run on the card must print the same metric
   lines as the same run on the CPU (plain versions);
4. timing at the main path's shapes: each kernel, its plain version and a
   yardstick PyTorch call, beside the least time the card could take.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then nonzero and no result line is printed.  Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet), used for the bound only
PEAK_F32_FLOPS = 67e12     # f32 FMA outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # HBM3

N_IMAGES, D_FEAT, D_CLIP, VOCAB, K = 130_048, 768, 512, 68_000, 100
TOPK = 5

# tolerances, with their reasons:
# - top-k logits are scale * f32 dot products summed in another order than
#   cuBLAS's: |error| ~ 1e-4 at scale 100, D = 512 unit vectors
TOPK_LOGIT_TOL = 2e-3
# - softmax values inherit the logit error (relative ~ logit error)
TOPK_PROB_TOL = 5e-4
# - squared distances of unit-norm rows in f32: |error| ~ 1e-6 per term
EM_DIST_TOL = 1e-4
# - sums of ~1000 f32 rows per cluster and the inertia sum of ~1e5 terms,
#   each summed in another order than the plain version's matmul
EM_SUM_RTOL, EM_SUM_ATOL = 1e-4, 1e-4
EM_INERTIA_RTOL = 1e-4
# floors of the fabricated structure (class signal far above the noise)
ACC_FLOOR, IOU_FLOOR = 0.90, 0.80


def fail(msg: str):
    raise RuntimeError(msg)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def section(title: str):
    print(f"== {title}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
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


# ------------------------------------------------------------- phase 1

def phase_build():
    from scd_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    reports = build.build(["topk_softmax", "fused_em"])
    for name, log in reports.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    build.load("topk_softmax")
    build.load("fused_em")
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- phase 2

def _unit(t, dim):
    return t / t.norm(dim=dim, keepdim=True).clamp_min(1e-12)


def topk_parity(n, d, v, k, gen, dup_cols=False, tag=""):
    """Kernel vs plain on one shape.  Indices must be equal wherever the
    exact (f64) logits of the two choices differ by more than
    TOPK_LOGIT_TOL; returns (max abs err of raw logits, of softmax)."""
    import torch

    from scd_tpu_torch.ops.topk import (classify_topk_plain,
                                        topk_softmax_cuda)

    dev = torch.device("cuda")
    f = _unit(torch.randn(n, d, generator=gen, device=dev), 1)
    w = _unit(torch.randn(d, v, generator=gen, device=dev), 0)
    if dup_cols:  # exact ties: column 2j+1 repeats column 2j (V even)
        w[:, 1::2] = w[:, 0::2]
    m, s, kv, ki = topk_softmax_cuda(f, w, k, scale=100.0)
    torch.cuda.synchronize()
    pv, pi = classify_topk_plain(f, w, k, 100.0, apply_softmax=False)
    diff = ki != pi
    if bool(diff.any()):
        rows = diff.any(dim=1).nonzero().flatten()
        f64 = f[rows].double()
        ek = 100.0 * (f64[:, None, :] * w.t()[ki[rows].long()].double()).sum(-1)
        ep = 100.0 * (f64[:, None, :] * w.t()[pi[rows].long()].double()).sum(-1)
        gap = (ek - ep).abs().max().item()
        check(gap <= TOPK_LOGIT_TOL,
              f"topk {tag}: indices differ beyond the tie band ({gap:.3e})")
    if dup_cols:
        # ties go to the lowest index: 2j+1 only ever right after 2j
        odd = (ki % 2 == 1)
        prev = torch.cat([torch.full_like(ki[:, :1], -2), ki[:, :-1]], 1)
        check(bool((~odd | (prev == ki - 1)).all()),
              f"topk {tag}: a tie did not go to the lowest index")
    err_raw = (kv - pv).abs().max().item()
    probs = torch.exp(kv - m[:, None]) / s[:, None]
    pprob, _ = classify_topk_plain(f, w, k, 100.0, apply_softmax=True)
    err_prob = (probs - pprob).abs().max().item()
    rel = err_raw / max(pv.abs().max().item(), 1e-30)
    check(err_raw <= TOPK_LOGIT_TOL, f"topk {tag}: logit error {err_raw}")
    check(err_prob <= TOPK_PROB_TOL, f"topk {tag}: softmax error {err_prob}")
    print(f"  topk_softmax {tag} N={n} D={d} V={v} k={k}: idx mismatches "
          f"{int(diff.sum())}, max abs err {err_raw:.3e} (rel {rel:.3e}), "
          f"softmax max abs err {err_prob:.3e}")
    return err_raw, err_prob


def em_inputs(n, d, k, gen):
    """Class-structured unit rows and centers picked from them."""
    import torch

    dev = torch.device("cuda")
    cls = 3.0 * torch.randn(k, d, generator=gen, device=dev)
    lab = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = _unit(cls[lab] + 0.5 * torch.randn(n, d, generator=gen, device=dev), 1)
    pick = torch.linspace(0, n - 1, k, device=dev).round().long()
    return x.contiguous(), x[pick].contiguous()


def em_parity(n, d, k, gen, masked=False, x_bf16=False, tag=""):
    """Kernel vs plain on one shape.  Labels must be equal wherever the
    exact (f64) squared distances of the two choices differ by more than
    EM_DIST_TOL; sums and counts are held against the plain segment sums
    of the kernel's own labels; returns max abs err of the sums."""
    import torch

    from scd_tpu_torch.ops.em import em_iteration_plain, fused_em_step_cuda
    from scd_tpu_torch.ops.segment import segment_sums

    x, c = em_inputs(n, d, k, gen)
    row_w = None
    if masked:
        row_w = (torch.rand(n, generator=gen, device=x.device) > 0.3).float()
    xk = x.to(torch.bfloat16) if x_bf16 else x
    lab, sums, counts, ine = fused_em_step_cuda(xk, c, row_w)
    torch.cuda.synchronize()
    lab2, sums2, counts2, ine2 = fused_em_step_cuda(xk, c, row_w)
    check(bool((lab == lab2).all()) and torch.equal(sums, sums2)
          and torch.equal(counts, counts2) and torch.equal(ine, ine2),
          f"fused_em {tag}: two runs on the same input differ")
    plab, psums, pcounts, pine = em_iteration_plain(xk, c, k, row_w)
    diff = lab.long() != plab.long()
    if bool(diff.any()):
        rows = diff.nonzero().flatten()
        x64 = xk[rows].double()
        dk = ((x64 - c[lab[rows].long()].double()) ** 2).sum(1)
        dp = ((x64 - c[plab[rows].long()].double()) ** 2).sum(1)
        gap = (dk - dp).abs().max().item()
        check(gap <= EM_DIST_TOL,
              f"fused_em {tag}: labels differ beyond the tie band ({gap:.3e})")
    rsums, rcounts = segment_sums(xk.float(), lab.long(), k, weights=row_w)
    err = (sums - rsums).abs().max().item()
    check(torch.allclose(sums, rsums, rtol=EM_SUM_RTOL, atol=EM_SUM_ATOL),
          f"fused_em {tag}: sums error {err}")
    check(torch.equal(counts, rcounts), f"fused_em {tag}: counts differ")
    rel = err / max(rsums.abs().max().item(), 1e-30)
    rel_ine = abs(ine.item() - pine.item()) / max(abs(pine.item()), 1e-30)
    check(rel_ine <= EM_INERTIA_RTOL, f"fused_em {tag}: inertia rel {rel_ine}")
    print(f"  fused_em_step {tag} N={n} D={d} K={k} mask={masked} "
          f"x_bf16={x_bf16}: label mismatches {int(diff.sum())}, sums max "
          f"abs err {err:.3e} (rel {rel:.3e}), inertia rel err {rel_ine:.3e}")
    return err


def phase_parity(seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    errs["topk_softmax"] = topk_parity(N_IMAGES - 32_512, D_CLIP, VOCAB,
                                       TOPK, gen, tag="slice")[0]
    topk_parity(1_005, 64, 1_003, 1, gen, tag="edge-k1")
    topk_parity(1_005, 64, 1_003, 16, gen, tag="edge-k16")
    topk_parity(777, 100, 2_000, 5, gen, dup_cols=True, tag="edge-ties")
    errs["fused_em_step"] = em_parity(N_IMAGES - 32_512, D_FEAT, K, gen,
                                      tag="slice")
    em_parity(N_IMAGES - 32_512, D_FEAT, K, gen, x_bf16=True,
              tag="slice-bf16")
    em_parity(1_005, 768, 7, gen, masked=True, tag="edge-K7")
    em_parity(20_000, 768, 683, gen, masked=True, tag="edge-K683")
    em_parity(3_001, 100, 130, gen, x_bf16=True, masked=True,
              tag="edge-bf16")
    return errs


# ------------------------------------------------------------- phase 3

def _metric_lines(text):
    prefixes = ("SSKM Accuracies:", "KM Accuracies:", "iter:",
                "Accuracies:", "ACC/sACC_avg/sACC_all:", "ACC/Soft sACC:",
                "IoU:")
    return [ln.rstrip() for ln in text.splitlines()
            if ln.startswith(prefixes)]


def phase_main_path(seed: int, workdir: str):
    import dataclasses

    import torch

    from scd_tpu_torch.cluster import kmeans
    from scd_tpu_torch.ops import em, topk
    from scd_tpu_torch.pipelines.unsup import run_unsup
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    t0 = time.perf_counter()
    cfg = imagenet100_config(os.path.join(workdir, "in100"))
    info = fabricate_imagenet100(cfg, seed=seed, device="cuda",
                                 n_images=N_IMAGES, d_feat=D_FEAT,
                                 d_clip=D_CLIP, vocab=VOCAB)
    check(info["n_images"] == N_IMAGES and info["n_labelled"] == 32_512,
          f"fabricated {info['n_images']} / {info['n_labelled']} rows")
    print(f"fabricated N={info['n_images']} (labelled "
          f"{info['n_labelled']}), V={len(info['nouns'])} in "
          f"{time.perf_counter() - t0:.1f} s")

    topk.topk_softmax_cuda.launches = 0
    em.fused_em_step_cuda.launches = 0
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_unsup(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {"topk_softmax": topk.topk_softmax_cuda.launches,
                "fused_em_step": em.fused_em_step_cuda.launches}
    for ln in _metric_lines(out.getvalue()):
        print("  " + ln)
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stage_seconds"].items())
        + f" | run_unsup {wall:.3f} s")
    estep = kmeans._ESTEP_PROBE_MEMO.get(
        ((N_IMAGES - 32_512, D_FEAT), K, "cuda"), (3, False))
    print(f"launches in run_unsup: {launches}; E-step mode "
          f"{'x_bf16' if estep[1] else 'exact'}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    u_preds = res["voting"].u_preds
    check(u_preds.shape == (N_IMAGES - 32_512,), f"u_preds {u_preds.shape}")
    acc = res["cluster_acc"][0]
    vote_acc = res["history"][-1]["all_acc"]
    check(acc >= ACC_FLOOR and vote_acc >= ACC_FLOOR,
          f"ACC {acc} / voted ACC {vote_acc} below {ACC_FLOOR}")
    check(res["iou"] >= IOU_FLOOR, f"IoU {res['iou']} below {IOU_FLOOR}")

    # small root: the card and the CPU print the same metric lines
    small = imagenet100_config(os.path.join(workdir, "small"), n_init=2,
                               max_iterations=5)
    fabricate_imagenet100(small, seed=seed, device="cuda", n_images=4_000,
                          d_feat=64, d_clip=32, vocab=3_000, n_genus=20)
    texts = {}
    for dev, run_cluster in (("cuda", True), ("cuda", False), ("cpu", False)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_unsup(dataclasses.replace(small, run_cluster=run_cluster),
                      device=dev)
        texts[(dev, run_cluster)] = _metric_lines(buf.getvalue())
    check(texts[("cuda", False)] == texts[("cpu", False)]
          and len(texts[("cpu", False)]) > 3,
          "small root: card and CPU metric lines differ")
    print(f"small root: {len(texts[('cpu', False)])} metric lines equal on "
          f"the card and the CPU")
    return launches, estep


# ------------------------------------------------------------- phase 4

def phase_timing(seed: int, estep):
    import torch

    from scd_tpu_torch.ops.em import em_iteration_plain, fused_em_step_cuda
    from scd_tpu_torch.ops.topk import classify_topk_plain, topk_softmax_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    n_u = N_IMAGES - 32_512
    f = _unit(torch.randn(n_u, D_CLIP, generator=gen, device="cuda"), 1)
    w = _unit(torch.randn(D_CLIP, VOCAB, generator=gen, device="cuda"), 0)

    def topk_library():
        for lo in range(0, n_u, 8192):
            logits = 100.0 * torch.matmul(f[lo:lo + 8192], w)
            torch.topk(logits, TOPK, dim=1)
            torch.logsumexp(logits, dim=1)

    t_topk = cuda_ms(lambda: topk_softmax_cuda(f, w, TOPK), reps=3)
    t_topk_plain = cuda_ms(
        lambda: classify_topk_plain(f, w, TOPK, 100.0), reps=1)
    t_topk_lib = cuda_ms(topk_library, reps=3)
    flops = 2.0 * n_u * D_CLIP * VOCAB
    nbytes = 4.0 * (n_u * D_CLIP + D_CLIP * VOCAB) + n_u * (8 + 8 * TOPK)
    topk_bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    topk_by = ("operations" if flops / PEAK_F32_FLOPS
               >= nbytes / PEAK_HBM_BYTES else "bytes")
    print(f"  topk_softmax N={n_u} D={D_CLIP} V={VOCAB} k={TOPK}: kernel "
          f"{t_topk:.3f} ms, plain {t_topk_plain:.3f} ms, library "
          f"{t_topk_lib:.3f} ms, bound {topk_bound:.3f} ms ({topk_by}); "
          f"{flops / (t_topk * 1e-3) / 1e12:.1f} TFLOP/s")
    del f, w

    x, c = em_inputs(n_u, D_FEAT, K, gen)
    xk = x.to(torch.bfloat16) if estep[1] else x

    def em_library():
        cross = torch.matmul(x, c.t())
        d2 = (c * c).sum(1)[None, :] - 2.0 * cross
        lab = torch.argmin(d2, dim=1)
        sums = torch.zeros(K, D_FEAT, device="cuda").index_add_(0, lab, x)
        return lab, sums

    t_em = cuda_ms(lambda: fused_em_step_cuda(xk, c), reps=50, warmup=3)
    t_em_plain = cuda_ms(lambda: em_iteration_plain(xk, c, K), reps=20)
    t_em_lib = cuda_ms(em_library, reps=20)
    x_bytes = 2 if estep[1] else 4
    em_flops = 2.0 * n_u * K * D_FEAT + n_u * D_FEAT
    em_bytes = (x_bytes * n_u * D_FEAT + 4.0 * K * D_FEAT + 4.0 * n_u
                + 4.0 * (K * D_FEAT + K + 1))
    em_bound = max(em_flops / PEAK_F32_FLOPS, em_bytes / PEAK_HBM_BYTES) * 1e3
    em_by = ("operations" if em_flops / PEAK_F32_FLOPS
             >= em_bytes / PEAK_HBM_BYTES else "bytes")
    print(f"  fused_em_step N={n_u} D={D_FEAT} K={K} "
          f"x_bf16={bool(estep[1])}: kernel {t_em:.4f} ms, plain "
          f"{t_em_plain:.4f} ms, library {t_em_lib:.4f} ms, bound "
          f"{em_bound:.4f} ms ({em_by})")
    return {
        "topk_softmax": (t_topk, t_topk_plain, t_topk_lib, topk_bound,
                         topk_by),
        "fused_em_step": (t_em, t_em_plain, t_em_lib, em_bound, em_by),
    }


KERNELS = {
    "topk_softmax": ("scd_tpu_torch/csrc/topk_softmax.cu",
                     "scd_tpu/ops/pallas_kernels.py:203"),
    "fused_em_step": ("scd_tpu_torch/csrc/fused_em.cu",
                      "scd_tpu/ops/pallas_kernels.py:545"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from scd_tpu_torch.core.device import f32_matmuls

    f32_matmuls()
    t_all = time.perf_counter()
    section("phase 1: device and build")
    t0 = time.perf_counter()
    phase_build()
    print(f"phase 1 {time.perf_counter() - t0:.1f} s")
    section("phase 2: kernel parity on the card")
    t0 = time.perf_counter()
    errs = phase_parity(args.seed)
    print(f"phase 2 {time.perf_counter() - t0:.1f} s")
    section("phase 3: main path (run_unsup, ImageNet-100 scale)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches, estep = phase_main_path(args.seed, workdir)
    print(f"phase 3 {time.perf_counter() - t0:.1f} s")
    section("phase 4: timing at the main path's shapes")
    t0 = time.perf_counter()
    times = phase_timing(args.seed, estep)
    print(f"phase 4 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_all:.1f} s")

    rows = []
    for name, (src, replaces) in KERNELS.items():
        ms, plain_ms, lib_ms, bound_ms, bound_by = times[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
