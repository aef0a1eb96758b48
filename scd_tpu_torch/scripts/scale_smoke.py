"""Production-scale smoke of the port: drive every hot pipeline stage at
ImageNet-100 shapes on one card, no assets needed.

    python -m scd_tpu_torch.scripts.scale_smoke [--small] [--device cuda|cpu]

The counterpart of ``scripts/scale_smoke.py``: the same fabricated data
(numpy ``default_rng(0)``, the same shapes and draws) through the same five
stages, each printing its wall-clock seconds, and ``main`` returns the
same ``results`` keys:

1. SSKM clustering of 98,304 unlabelled + 32,768 labelled 768-d features
   (``fused_em_step`` on the card);
2. ConSSKM with the Sinkhorn E-step on the device at the same scale;
3. the vocabulary top-k over [N, 512] x [512, 68,000] (``topk_softmax``);
4. the voting loop to its fixpoint;
5. the ptsup zero-shot bounds (full and GT-restricted vocabulary; the
   ``topk_softmax`` kernel at k 1 over raw logits).

``--small`` takes the CI shapes (seconds on the CPU).  The seeds of the
k-means++ draws differ from the JAX package's (``torch.Generator`` against
threefry), so the clusterings agree by ACC, not label for label; the
top-k and the bounds see no random draw and agree to float rounding.
``chip_smoke.py`` already times these stages at full shape on the card in
its phases 3 (SSKM, the vocabulary top-k and the voting loop in
``run_unsup``) and 8 (ConSSKM on the Sinkhorn track and the ptsup bounds
in ``run_ptsup``); phase 16 runs this script at ``--small`` on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


class _Stage:
    def __init__(self, name: str, sync):
        self.name, self.sync = name, sync

    def __enter__(self):
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        print(f"[scale_smoke] {self.name}: "
              f"{time.perf_counter() - self.t0:.2f}s", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="CI shapes (CPU-runnable in seconds)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)

    import torch

    from scd_tpu_torch.cluster import fit_constrained, fit_sskm
    from scd_tpu_torch.core.config import ClusterConfig, NamingConfig
    from scd_tpu_torch.core.device import resolve_device
    from scd_tpu_torch.metrics import split_cluster_acc_v2
    from scd_tpu_torch.naming.loop import voting_loop
    from scd_tpu_torch.naming.vote import topk_names
    from scd_tpu_torch.pipelines.ptsup import _top1_acc, zero_shot_preds

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.small:
        n_u, n_l, d_feat, d_clip, v, k = 3000, 800, 64, 32, 3000, 10
        size_min, size_max = 30, 2000
        max_iter, n_init = 10, 2
    else:
        n_u, n_l, d_feat, d_clip, v, k = 98304, 32768, 768, 512, 68000, 100
        size_min, size_max = 50, 1200
        max_iter, n_init = 20, 3

    rng = np.random.default_rng(0)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[scale_smoke] shapes: N_u={n_u} N_l={n_l} D={d_feat}/{d_clip} "
          f"V={v} K={k} on {where}", flush=True)

    # class-structured features: cluster c's members sit around a center
    feat_centers = rng.standard_normal((k, d_feat)).astype(np.float32) * 3
    clip_centers = rng.standard_normal((k, d_clip)).astype(np.float32)
    clip_centers /= np.linalg.norm(clip_centers, axis=1, keepdims=True)
    u_true = rng.integers(0, k, n_u)
    l_true = rng.integers(0, k // 2, n_l)  # labelled classes: first half
    u_feats = (feat_centers[u_true]
               + 0.5 * rng.standard_normal((n_u, d_feat)).astype(np.float32))
    l_feats = (feat_centers[l_true]
               + 0.5 * rng.standard_normal((n_l, d_feat)).astype(np.float32))
    clip_u = (clip_centers[u_true]
              + 0.1 * rng.standard_normal((n_u, d_clip)).astype(np.float32))
    clip_u /= np.linalg.norm(clip_u, axis=1, keepdims=True)

    # vocabulary: GT name columns embed the clip class signatures
    nouns = [f"name_{i}" for i in range(v)]
    zw = rng.standard_normal((d_clip, v)).astype(np.float32)
    zw /= np.linalg.norm(zw, axis=0, keepdims=True)
    stride = v // k
    gt_cols = np.arange(k) * stride
    zw[:, gt_cols] = clip_centers.T
    cidx_to_cname = {c: nouns[gt_cols[c]] for c in range(k)}

    results: dict = {}

    with _Stage(f"SSKM fit (n_init={n_init}, max_iter={max_iter}; incl. "
                "feature upload)", sync):
        cfg = ClusterConfig(algorithm="SSKM", n_clusters=k, n_init=n_init,
                            max_iterations=max_iter, seed=0)
        res = fit_sskm(u_feats, l_feats, l_true, cfg, device=dev)
    u_preds0 = np.asarray(res.labels)[n_l:]
    mask_old = u_true < k // 2
    accs = split_cluster_acc_v2(u_true, u_preds0, mask_old)
    results["sskm_acc"] = accs
    print(f"[scale_smoke]   SSKM ACC all/old/new: "
          f"{accs[0]:.3f}/{accs[1]:.3f}/{accs[2]:.3f}", flush=True)

    with _Stage("ConSSKM fit (sinkhorn E-step on device)", sync):
        ccfg = ClusterConfig(algorithm="ConSSKM", n_clusters=k,
                             n_init=max(n_init - 1, 1), max_iterations=10,
                             size_min=size_min, size_max=size_max,
                             constrained_backend="sinkhorn", seed=1)
        cres = fit_constrained(u_feats, l_feats, l_true, ccfg, device=dev)
    sizes = np.bincount(np.asarray(cres.labels)[n_l:], minlength=k)
    assert sizes.min() >= size_min and sizes.max() <= size_max, \
        f"size constraints violated: [{sizes.min()}, {sizes.max()}]"
    results["consskm_sizes"] = (int(sizes.min()), int(sizes.max()))
    print(f"[scale_smoke]   ConSSKM sizes in [{sizes.min()}, {sizes.max()}]",
          flush=True)

    clip_t = torch.from_numpy(clip_u).to(dev)
    zw_t = torch.from_numpy(zw).to(dev)
    with _Stage(f"vocabulary top-k ([{n_u}, {d_clip}] x [{d_clip}, {v}])",
                sync):
        name_idx, _vals = topk_names(clip_t, zw_t, k=5)
    results["topk_hit"] = float((name_idx[:, 0] == gt_cols[u_true]).mean())
    print(f"[scale_smoke]   top-1 name hit rate: {results['topk_hit']:.3f}",
          flush=True)

    with _Stage("voting loop to fixpoint", sync):
        ncfg = NamingConfig(topk=5, num_common_vote=20, num_common_linear=4)
        vres = voting_loop(nouns, name_idx, clip_t, zw_t, u_preds0, k, ncfg)
    gt_names = [cidx_to_cname[int(t)] for t in u_true]
    named_acc = float(np.mean([
        vres.cand_names[p] == g
        for p, g in zip(vres.u_preds, gt_names)
        if p < len(vres.cand_names)]))
    results["voting_iters"] = vres.n_iters
    results["voting_sacc"] = named_acc
    print(f"[scale_smoke]   voting: {vres.n_iters} iters, "
          f"{len(vres.cand_names)} names, sACC~{named_acc:.3f}", flush=True)

    with _Stage("zero-shot bounds (full + GT-restricted vocabulary)", sync):
        lb_preds = zero_shot_preds(clip_t, zw_t)
        lb = _top1_acc(lb_preds, u_true, cidx_to_cname, nouns)
        zw_gt = zw_t[:, torch.from_numpy(gt_cols).to(dev)].contiguous()
        ub_preds = zero_shot_preds(clip_t, zw_gt)
        ub = _top1_acc(ub_preds, u_true, cidx_to_cname,
                       [cidx_to_cname[c] for c in range(k)])
    results["lb"], results["ub"] = lb, ub
    print(f"[scale_smoke]   sACC LB {lb:.1f} / UB {ub:.1f}", flush=True)

    print(f"[scale_smoke] done: {results}", flush=True)
    return results


if __name__ == "__main__":
    main()
