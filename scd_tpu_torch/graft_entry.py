"""The port's entry points for a one-device forward and a multi-rank dry
run: the counterpart of ``__graft_entry__.py``.

- :func:`entry` returns the forward of the flagship model (the CLIP
  ViT-B/16 image encoder, bf16 compute) and its example arguments, with
  weights drawn from a fixed seed (``testing.fabricate.clip_state_dict``).
- :func:`dryrun_multichip` runs, over ``n_devices`` gloo ranks
  (``testing/dist.py::spawn``; on the card they share it), a mesh of
  ``data n/2 x model 2`` (``data n x model 1`` when n is odd) and, at
  tiny shapes, the JAX dry run's seven parts: (1) one whole GCD training
  step, the batch over ``data`` and the attention and MLP parameters over
  ``model``; (2) the vocabulary-sharded softmax top-k; (3) ConSSKM over
  ``data`` (the Sinkhorn E-step); (4) the name-sharded zero-shot
  vocabulary build; (4b) the fused E + M k-means over ``data``; (5) the
  data-sharded feature extraction; (6) one UNO end-to-end step under
  ``data x model``.  Parts 3-5 shard over ``data`` with the ``model``
  ranks as replicas.  Together they run every collective the port uses:
  the gradient ``all_reduce`` over ``data``, the tensor-parallel pair
  over ``model``, the top-k merge's gathers, the row gathers.

Run: ``python -m scd_tpu_torch.graft_entry [--device cpu]`` (the
forward once, its output shape, as the JAX module's ``__main__``); the
dry run: ``python -c "from scd_tpu_torch.graft_entry import
dryrun_multichip; dryrun_multichip(8)"`` (``device="cpu"`` for CPU
ranks).
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch


def entry(device="cuda"):
    """(forward, (model, images)): ``forward(model, images)`` is the CLIP
    ViT-B/16 image encoder at bf16 compute on zeros [4, 224, 224, 3]
    (NHWC), returning [4, 512] f32; ``device`` where it runs."""
    from scd_tpu_torch.core.device import resolve_device
    from scd_tpu_torch.models import load_openai_clip_weights
    from scd_tpu_torch.models.clip import CLIPModel, clip_vit_b16_config
    from scd_tpu_torch.models.params import params_from_flax
    from scd_tpu_torch.testing.fabricate import clip_state_dict

    dev = resolve_device(device)
    cfg = clip_vit_b16_config(compute_dtype=torch.bfloat16)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_flax(load_openai_clip_weights(
        clip_state_dict(cfg, seed=0), cfg)))
    model = model.to(dev)
    images = torch.zeros((4, 224, 224, 3), dtype=torch.float32, device=dev)

    def forward(model, images):
        with torch.no_grad():
            return model.encode_image(images)

    return forward, (model, images)


def _tokens(texts):
    """Tiny token rows: a start id, then a 9 at a slot picked by the
    text's crc32 (stable across processes, unlike ``hash``)."""
    t = np.zeros((len(texts), 12), np.int32)
    for i, s in enumerate(texts):
        t[i, 0] = 7
        t[i, 1 + (zlib.crc32(s.encode()) % 9)] = 9
    return t


def dryrun_rank(n_model: int) -> str:
    """One rank of :func:`dryrun_multichip` (every rank runs it): the
    seven parts over the world's mesh of ``data world / n_model x model
    n_model``; returns the summary line."""
    from scd_tpu_torch.cluster import fit_constrained, fit_kmeans
    from scd_tpu_torch.core import multihost
    from scd_tpu_torch.core.config import (ClusterConfig, MeshConfig,
                                           TrainConfig)
    from scd_tpu_torch.core.mesh import make_mesh
    from scd_tpu_torch.models.params import flax_init_
    from scd_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights_sharded
    from scd_tpu_torch.ops.topk import classify_topk_sharded
    from scd_tpu_torch.pipelines.common import (_pod_shard,
                                                make_sharded_image_encoder)
    from scd_tpu_torch.train.baselines_e2e import train_uno_e2e
    from scd_tpu_torch.train.gcd import GCDTrainer

    world = multihost.process_count()
    mesh = make_mesh(MeshConfig(data=world // n_model, model=n_model))
    dev = mesh.device

    # (1) one whole GCD training step: the batch over data, the attention
    # and MLP parameters over model
    vit_cfg = ViTConfig(image_size=16, patch_size=8, width=32, depth=2,
                        heads=4)
    tr = GCDTrainer(vit_cfg, TrainConfig(grad_from_block=1, proj_dim=64,
                                         lr=0.1),
                    seed=0, total_steps=10, mesh=mesh, device=dev)
    b = 2 * mesh.n_data
    images = np.random.default_rng(0).standard_normal(
        (2 * b, 16, 16, 3)).astype(np.float32)
    lo, hi = multihost.share_bounds(b, mesh.n_data, mesh.data_index)
    batch = {"images": np.concatenate([images[lo:hi], images[b + lo:b + hi]]),
             "labels": np.arange(b)[lo:hi] % 3,
             "mask_lab": (np.arange(b) % 2 == 0)[lo:hi]}
    loss = float(tr.step_fn(tr.model, tr.opt, tr.to_device(batch))["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("sharded train step produced a non-finite loss")

    # (2) vocabulary-sharded fused softmax -> top-k
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((8, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    weights = rng.standard_normal((16, 32 * mesh.n_model)).astype(np.float32)
    vals, _idx = classify_topk_sharded(feats, weights, k=3, mesh=mesh)
    if tuple(vals.shape) != (8, 3):
        raise RuntimeError(f"top-k shape {tuple(vals.shape)}")

    # (3) data-sharded constrained clustering (the Sinkhorn E-step;
    # padded rows take the sentinel label and no transport mass)
    x = rng.standard_normal((101, 8)).astype(np.float32)
    y = rng.integers(0, 2, 101)
    mask = np.arange(101) % 3 == 0
    ccfg = ClusterConfig(algorithm="ConSSKM", n_clusters=4, n_init=2,
                         max_iterations=4, size_min=5, size_max=40,
                         constrained_backend="sinkhorn", seed=1)
    res = fit_constrained(_pod_shard(x[~mask], mesh), x[mask], y[mask], ccfg,
                          device=dev, mesh=mesh)
    sizes = np.bincount(res.labels[int(mask.sum()):], minlength=4)
    if sizes.sum() != int((~mask).sum()):
        raise RuntimeError(f"ConSSKM sizes {sizes.tolist()}")

    # (4) names-sharded zero-shot vocabulary build (each data rank embeds
    # its slice of every batch of names; the gathered weights replicate)
    table = torch.as_tensor(rng.standard_normal((12, 16)),
                            dtype=torch.float32, device=dev)

    def text_forward(variables, toks):
        toks = torch.as_tensor(np.asarray(toks), device=dev)
        return variables["table"][toks[:, 1].long()] \
            + toks.sum(dim=1, keepdim=True) * 0.0

    zw = build_zeroshot_weights_sharded(
        text_forward, {"table": table}, _tokens,
        [f"name{i}" for i in range(19)], ["a {}", "the {}"],
        names_per_batch=8, mesh=mesh)
    if tuple(zw.shape) != (16, 19):
        raise RuntimeError(f"zero-shot weights {tuple(zw.shape)}")

    # (4b) the fused E + M k-means over the data axis: each rank's
    # partial sums merged once an iteration
    x_km = rng.standard_normal((16 * mesh.n_data, 8)).astype(np.float32)
    km = fit_kmeans(_pod_shard(x_km, mesh),
                    ClusterConfig(n_clusters=3, n_init=2, max_iterations=5,
                                  fused_mesh=True, seed=3),
                    device=dev, mesh=mesh)
    if not np.isfinite(km.inertia):
        raise RuntimeError("fused k-means inertia is not finite")

    # (5) data-sharded feature extraction: rows over data, the encoder
    # replicated; a ragged tail pads and is dropped
    enc = flax_init_(VisionTransformer(vit_cfg), 2).to(dev)

    def encode(rows):
        with torch.no_grad():
            return enc(torch.as_tensor(rows, device=dev)).cpu().numpy()

    encode_sharded = make_sharded_image_encoder(encode, mesh)
    imgs = rng.standard_normal((2 * mesh.n_data + 1, 16, 16, 3)).astype(
        np.float32)
    feats_sh = encode_sharded(_pod_shard(imgs, mesh))
    if feats_sh.shape[0] != imgs.shape[0] or not np.isfinite(feats_sh).all():
        raise RuntimeError(f"sharded encode {feats_sh.shape}")

    # (6) UNO end-to-end under data x model (trunk finetuning with
    # Sinkhorn pseudo-labels over the global batch)
    uv = rng.standard_normal((2, 2 * b, 16, 16, 3)).astype(np.float32)
    _state, _predict, hist = train_uno_e2e(
        4, uv, np.arange(2 * b) % 3, np.arange(2 * b) % 2 == 0, n_labeled=2,
        n_unlabeled=2, vit_cfg=vit_cfg, num_heads=2, epochs=1, batch_size=b,
        lr=0.05, warmup_epochs=0, mesh=mesh, device=dev)
    uno_loss = float(hist[0]["loss"])
    if not np.isfinite(uno_loss):
        raise RuntimeError("sharded UNO e2e step: non-finite loss")

    shape = {"data": mesh.n_data, "model": mesh.n_model}
    return (f"dryrun_multichip ok: mesh={shape}, train loss={loss:.4f}, "
            f"topk shard merge ok, sharded ConSSKM sizes={sizes.tolist()}, "
            f"zeroshot [16,19] ok, fused mesh KM inertia={km.inertia:.1f}, "
            f"sharded encode {list(feats_sh.shape)} ok, "
            f"UNO e2e dp+tp loss={uno_loss:.4f}")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> str:
    """Run :func:`dryrun_rank` in ``n_devices`` gloo ranks on ``device``
    (``cuda``: they share the card; ``cpu``), ``model`` 2 when
    ``n_devices`` is even, else 1; every rank must end on the same line,
    which is printed and returned.  A failed rank raises with its
    traceback."""
    from scd_tpu_torch.testing.dist import spawn

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    lines = spawn("scd_tpu_torch.graft_entry.dryrun_rank", world=n_devices,
                  backend="gloo", device=device, args=(n_model,),
                  timeout=timeout)
    if any(line != lines[0] for line in lines):
        raise RuntimeError("the ranks' dry runs differ:\n" + "\n".join(lines))
    print(lines[0])
    return lines[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    fn, fn_args = entry(device=args.device)
    out = fn(*fn_args)
    print("entry forward:", tuple(out.shape))


if __name__ == "__main__":
    main()
