"""Multi-process smoke of the port: N processes x M ranks each run the SAME
program over one global mesh of ranks (``torch.distributed``, one rank a
device), each feeding its own row shard; the counterpart of
``scripts/multihost_smoke.py``.

Launcher (starts every rank locally, compares their digests):

    python -m scd_tpu_torch.scripts.multihost_smoke --launch 2 \\
        [--devices_per_proc 1] [--pipeline unsup|ptsup|train] [--device cpu]

The world is ``--launch`` x ``--devices_per_proc`` ranks, the JAX rig's
global mesh: the ranks start through ``testing/dist.py::spawn`` (fresh
interpreters, a ``file://`` store, gloo; on a card every rank binds it, so
gloo ranks share one card).  A worker under ``torchrun`` (as the port's
CLIs run on several cards) is the same program without ``--launch``:

    torchrun --nproc_per_node N -m scd_tpu_torch.scripts.multihost_smoke

Each rank prints one digest line, as the JAX worker does: ``MULTIHOST``
(the default stage smoke: k-means, SSKM and Sinkhorn-constrained fits on
row shards, the sharded encoder into k-means, ragged shards, the voting
loop on the top-k, the name-sharded vocabulary build, the
vocabulary-sharded top-k over a ``model`` axis of 2), ``PIPELINE``
(``--pipeline unsup|ptsup``: the whole synthetic pipeline over the ranks)
or ``TRAIN`` (``--pipeline train``: a GCD step at ``model`` 2, then UNO
and AutoNovel end to end, on the tensor-parallel trainers).  The launcher
exits 0 only when every rank printed the same digest.  The stages reuse
``testing/mesh_cases.py`` (the sharded encoder and its ragged batch, the
vocabulary build, the synthetic runs, the tiny trainers).
``tests/test_torch_multihost_smoke.py`` also holds the k-means and SSKM
results against a single JAX process on the same global data (inertia
within 1e-3 relative, ARI above 0.99: the ranks' merged sums reassociate
and the k-means++ draws differ, so bits are not the contract).
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np


def global_blobs(n_global: int = 256, d: int = 16, k: int = 5,
                 seed: int = 0) -> tuple:
    """Deterministic global dataset every rank can regenerate (the JAX
    script's)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 6
    labels = np.arange(n_global) % k
    x = centers[labels] + rng.standard_normal((n_global, d)).astype(np.float32)
    return x, labels


def _crc(a) -> str:
    return f"{zlib.crc32(np.ascontiguousarray(a).tobytes()):08x}"


def _labels(res) -> np.ndarray:
    return np.asarray(res.labels).astype(np.int32)


def stage_worker(dump_dir: str = "") -> str:
    """The default stage smoke on this rank's shards; returns (and prints)
    its ``MULTIHOST`` digest."""
    import torch

    from scd_tpu_torch.cluster import fit_constrained, fit_kmeans, fit_sskm
    from scd_tpu_torch.core import multihost
    from scd_tpu_torch.core.config import (ClusterConfig, MeshConfig,
                                           NamingConfig)
    from scd_tpu_torch.core.mesh import make_mesh
    from scd_tpu_torch.naming.loop import voting_loop
    from scd_tpu_torch.naming.vote import topk_names
    from scd_tpu_torch.ops.topk import classify_topk_sharded
    from scd_tpu_torch.testing import mesh_cases as mc

    world = multihost.process_count()
    mesh = make_mesh(MeshConfig(data=world, model=1))
    dev = mesh.device
    x, _y = global_blobs()
    local = mc._share(x, mesh)
    res = fit_kmeans(local, ClusterConfig(n_clusters=5, n_init=4,
                                          max_iterations=25, seed=0),
                     mesh=mesh)

    # SSKM and Sinkhorn-constrained: unlabelled rows shard per rank, the
    # labelled set is the same full copy on every rank
    xl, yl = global_blobs(n_global=80, seed=3)
    res_sskm = fit_sskm(local, xl, yl, ClusterConfig(
        n_clusters=5, n_init=2, max_iterations=15, seed=4), mesh=mesh)
    res_con = fit_constrained(local, xl, yl, ClusterConfig(
        n_clusters=5, n_init=2, max_iterations=10, size_min=1,
        size_max=len(x), constrained_backend="sinkhorn", seed=5),
        mesh=mesh)

    # the sharded encoder (a tiny ViT) on a full and a ragged batch and
    # extraction over the ranks, then k-means on the encoded features
    enc = mc._extraction(mesh, dev, 64)
    feats = np.asarray(enc["full"][0], np.float32)  # [64, D] on every rank
    res_enc = fit_kmeans(mc._share(feats, mesh), ClusterConfig(
        n_clusters=3, n_init=2, max_iterations=10, seed=2), mesh=mesh)
    xr, _yr = global_blobs(n_global=60, d=16, k=4, seed=22)
    res_rag = fit_kmeans(mc._share(xr, mesh), ClusterConfig(
        n_clusters=4, n_init=2, max_iterations=15, seed=6), mesh=mesh)
    assert len(res_rag.labels) == 60

    # naming on top: the top-k of every image's vocabulary logits, then
    # the voting loop (host work, the same on every rank)
    n_vocab = 24
    zw = np.random.default_rng(11).standard_normal(
        (feats.shape[1], n_vocab)).astype(np.float32)
    zw /= np.linalg.norm(zw, axis=0, keepdims=True)
    f_t, zw_t = torch.from_numpy(feats).to(dev), torch.from_numpy(zw).to(dev)
    tidx, _ = topk_names(f_t, zw_t, 5, apply_softmax=False)
    nouns = [f"name_{i}" for i in range(n_vocab)]
    vote = voting_loop(nouns, tidx, f_t, zw_t, _labels(res_enc), 3,
                       NamingConfig(topk=5, num_common_vote=8,
                                    num_common_linear=4, max_vote_iters=6))

    # the name-sharded vocabulary build, and the vocabulary-sharded top-k
    # over a model axis of 2 (when the world is even)
    vocab = mc._vocabulary(mesh, dev)["sharded"]
    topk = "-"
    if world % 2 == 0:
        vmesh = make_mesh(MeshConfig(data=world // 2, model=2))
        _vals, idx = classify_topk_sharded(feats, zw, 4, vmesh)
        topk = _crc(idx.cpu().numpy().astype(np.int32))

    digest = (f"MULTIHOST {res.inertia:.4f} {_crc(_labels(res))} "
              f"feats {_crc(np.round(feats, 4))} "
              f"enc_km {res_enc.inertia:.3f} "
              f"sskm {res_sskm.inertia:.3f} {_crc(_labels(res_sskm))} "
              f"con {res_con.inertia:.3f} {_crc(_labels(res_con))} "
              f"vote {zlib.crc32(','.join(vote.cand_names).encode()):08x} "
              f"{_crc(np.asarray(vote.u_preds, np.int32))} "
              f"zw {_crc(np.round(vocab, 5))} topk {topk} "
              f"ragenc {_crc(np.round(enc['ragged'][0], 4))} "
              f"ragkm {res_rag.inertia:.3f} {_crc(_labels(res_rag))}")
    if dump_dir:
        r = multihost.process_index()
        np.save(os.path.join(dump_dir, f"labels_{r}.npy"), _labels(res))
        np.save(os.path.join(dump_dir, f"labels_sskm_{r}.npy"),
                _labels(res_sskm))
        np.save(os.path.join(dump_dir, f"zw_{r}.npy"), vocab)
    print(digest, flush=True)
    return digest


def pipeline_worker(dump_dir: str, kind: str) -> str:
    """The whole synthetic pipeline (``kind``: unsup or ptsup) over the
    ranks: extraction decodes this rank's share, clustering shards the
    unlabelled rows, the vocabulary, top-k, voting and metrics replicate.
    Returns (and prints) its ``PIPELINE`` digest."""
    import tempfile

    from scd_tpu_torch.core import multihost
    from scd_tpu_torch.testing import mesh_cases as mc

    root = dump_dir or tempfile.mkdtemp(prefix="scd_mh_")
    cache = os.path.join(root, f"cache_{kind}_p{multihost.process_index()}")
    if kind == "ptsup":
        from scd_tpu_torch.pipelines.ptsup import run_ptsup as run
    else:
        from scd_tpu_torch.pipelines.unsup import run_unsup as run
    res, _lines = mc._lines(run, mc._synthetic_config(cache),
                            device=multihost.local_device().type)
    vote = res["voting"]
    acc = res.get("cluster_acc", (float("nan"),) * 3)
    digest = (f"PIPELINE {kind} acc {acc[0]:.4f}/{acc[1]:.4f}/{acc[2]:.4f} "
              f"iou {res['iou']:.4f} "
              f"names {zlib.crc32(','.join(vote.cand_names).encode()):08x} "
              f"preds {_crc(np.asarray(vote.u_preds, np.int32))} "
              f"run {mc.run_digest(res)[:16]}")
    print(digest, flush=True)
    return digest


def train_worker() -> str:
    """One GCD step at ``model`` 2, then UNO and AutoNovel end to end, on
    the tensor-parallel trainers (``testing/mesh_cases.py::
    tiny_trainers``, a tiny ViT of 4 heads); returns (and prints) its
    ``TRAIN`` digest."""
    from scd_tpu_torch.core import multihost
    from scd_tpu_torch.core.config import MeshConfig
    from scd_tpu_torch.core.mesh import make_mesh
    from scd_tpu_torch.testing import mesh_cases as mc

    world = multihost.process_count()
    if world % 2:
        raise ValueError(f"--pipeline train runs at model 2: the world "
                         f"({world} ranks) must be even")
    out = mc.tiny_trainers(make_mesh(MeshConfig(data=world // 2, model=2)),
                           4)
    digest = (f"TRAIN gcd {out['make_gcd_state']:.5f} "
              f"tp_bytes {out['GCDTrainer']} "
              f"uno {out['train_uno_e2e']:.5f} "
              f"an {out['train_autonovel_e2e']:.5f}")
    print(digest, flush=True)
    return digest


def worker(dump_dir: str = "", pipeline: str = "") -> str:
    """One rank's program (``torch.distributed`` already initialized)."""
    if pipeline == "train":
        return train_worker()
    if pipeline:
        return pipeline_worker(dump_dir, pipeline)
    return stage_worker(dump_dir)


def launch(num_processes: int, devices_per_proc: int, dump_dir: str = "",
           pipeline: str = "", device: str = "cuda",
           timeout: float = 600.0) -> int:
    """Every rank of the ``num_processes x devices_per_proc`` world through
    ``testing/dist.py::spawn``; 0 when every rank's digest is the same."""
    from scd_tpu_torch.testing.dist import spawn

    world = num_processes * devices_per_proc
    try:
        digests = spawn("scd_tpu_torch.scripts.multihost_smoke.worker",
                        world=world, backend="gloo", device=device,
                        args=(dump_dir, pipeline), timeout=timeout)
    except RuntimeError as e:
        print(f"[launch] a rank failed: {e}", file=sys.stderr)
        return 1
    if len(set(digests)) == 1:
        print(f"multihost smoke ok: {num_processes} processes x "
              f"{devices_per_proc} ranks on {device}, digest "
              f"{digests[0]!r}", flush=True)
        return 0
    print(f"[launch] digest mismatch: {digests}", file=sys.stderr)
    return 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--launch", type=int, default=0,
                   help="start N local processes (x --devices_per_proc "
                        "ranks) and compare their digests")
    p.add_argument("--devices_per_proc", type=int, default=1,
                   help="ranks a process stands for: the world is "
                        "--launch x this, one rank a device")
    p.add_argument("--dump_dir", type=str, default="",
                   help="save each rank's labels_<rank>.npy here")
    p.add_argument("--pipeline", nargs="?", const="unsup", default="",
                   choices=["", "unsup", "ptsup", "train"],
                   help="run a FULL pipeline (synthetic) or the training "
                        "steps instead of the stage smoke: "
                        "--pipeline [unsup|ptsup|train]")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; gloo ranks share the card) or cpu")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds for the whole world, start-up included")
    args = p.parse_args(argv)
    if args.launch:
        sys.exit(launch(args.launch, args.devices_per_proc, args.dump_dir,
                        args.pipeline, args.device, args.timeout))
    from scd_tpu_torch.core import multihost

    multihost.initialize(device=args.device)
    try:
        worker(args.dump_dir, args.pipeline)
        multihost.barrier()
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
