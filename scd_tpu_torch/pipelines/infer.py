"""Serving entry point: name images with a discovered vocabulary.

Port of ``scd_tpu/pipelines/infer.py``.  The discovery pipeline ends at a
candidate name set and per-image assignments; this module applies that
result to new images: load the CLIP image tower and the zero-shot weight
columns of a (candidate) name list once, then classify image batches to
names.

Per batch: uint8 images to the device, normalize there, the CLIP image
tower (its attention through the ``csrc/attention.cu`` kernel on a CUDA
device), then the head — L2-normalize, ``[B, D] @ [D, K]``, softmax and
top-k in plain PyTorch, as the JAX package leaves them to XLA.  One
device per rank: ``cuda`` unless the caller passes ``--device cpu``.
Under ``torchrun --nproc_per_node N ... --mesh_data N`` every batch splits
over the ranks (``build_clip_encoder(mesh=...)``: each rank encodes its
contiguous rows, the features gather on every rank) and rank 0 prints
the names.  ``--mesh_data`` above the launched ranks raises.

Run (asset-free smoke):
  python -m scd_tpu_torch.pipelines.infer --dataset_name synthetic --topk 3
Real use — names every image of a directory (flat or imagefolder layout)
or of a .npy / .npz batch, batch 128:
  python -m scd_tpu_torch.pipelines.infer --dataset_name real \
    --clip_weights ViT-B-16.pt --zeroshot_weights zw.npz \
    --names names.txt --images /path/to/images --batch_size 128
(--clip_weights random = a tower with seeded random weights, for smoke
 and load tests.)
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Sequence

import numpy as np
import torch

from scd_tpu_torch.core.device import resolve_device


class NameClassifier:
    """Image -> name classifier over a fixed candidate-name weight matrix.

    ``encode_image(images) -> [B, D]`` is any image encoder (the CLIP
    encoder of :func:`build_clip_encoder`, or the synthetic stand-in);
    ``weights`` [D, K] are the L2-normalized zero-shot columns of
    ``names``.  The head runs on ``device`` (``cuda`` unless the caller
    asks for the CPU; a CUDA request without a card raises), whatever the
    encoder is: a bound method exposes no attribute of its instance, so
    nothing is read from it.
    """

    def __init__(self, encode_image: Callable, weights, names: Sequence[str],
                 logit_scale: float = 100.0, device="cuda"):
        if weights.shape[1] != len(names):
            raise ValueError(
                f"weights [D, K={weights.shape[1]}] vs {len(names)} names")
        self.encode_image = encode_image
        self.names = list(names)
        self.logit_scale = float(logit_scale)
        self.device = resolve_device(device)
        self._w = torch.as_tensor(
            weights if isinstance(weights, torch.Tensor)
            else np.asarray(weights, np.float32)).to(self.device).float()

    def _head(self, feats: torch.Tensor, k: int):
        f = feats.float()
        f = f / torch.clamp_min(torch.linalg.norm(f, dim=-1, keepdim=True),
                                1e-12)
        probs = torch.softmax(self.logit_scale * (f @ self._w), dim=-1)
        return torch.topk(probs, k, dim=-1)  # (values, indices)

    def classify(self, images, topk: int = 1):
        """[B, H, W, C] images -> (names [B][topk], probs [B, topk])."""
        topk = min(int(topk), len(self.names))
        feats = torch.as_tensor(self.encode_image(images)).to(self.device)
        vals, idx = self._head(feats, topk)
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        return [[self.names[j] for j in row] for row in idx], vals


def classifier_from_run(encode_image: Callable, zeroshot_weights,
                        nouns: Sequence[str], cand_names: Sequence[str],
                        logit_scale: float = 100.0,
                        device="cuda") -> NameClassifier:
    """A serving classifier from a finished voting-loop run: the candidate
    names' columns of the full-vocabulary weights (the re-classification
    matrix the loop converged with, ``naming/loop.py::_reclassify``)."""
    col = {n: i for i, n in enumerate(nouns)}
    missing = [n for n in cand_names if n not in col]
    if missing:
        raise KeyError(f"candidate names not in vocabulary: {missing[:5]}")
    from scd_tpu_torch.naming.loop import gather_weight_columns

    w = gather_weight_columns(torch.as_tensor(zeroshot_weights),
                              [col[n] for n in cand_names])
    return NameClassifier(encode_image, w, cand_names,
                          logit_scale=logit_scale, device=device)


def build_clip_encoder(variables, cfg, device="cuda", mesh=None) -> Callable:
    """The serving image encoder: the CLIP image tower with ``variables``
    (a Flax-layout tree) on ``device``, normalizing uint8 NHWC batches
    there.  ``encode(images)`` returns the [B, D] f32 features on the
    device.  With a ``mesh`` it takes the full batch on every rank, each
    rank encodes its contiguous share of the rows
    (``pipelines/common.py::make_sharded_image_encoder``) and every rank
    gets the [B, D] features (host numpy); every rank's weights are
    checked to be rank 0's."""
    from scd_tpu_torch.data.transforms import device_normalize_clip
    from scd_tpu_torch.models import CLIPModel, params_from_flax

    dev = resolve_device(device)
    model = CLIPModel(cfg, device=dev).eval()
    model.load_state_dict(params_from_flax(variables))

    def encode(images):
        x = torch.as_tensor(images).to(dev, non_blocking=True)
        with torch.inference_mode():
            return model.encode_image(device_normalize_clip(x))

    if mesh is None:
        return encode
    from scd_tpu_torch.core.multihost import replicate_to_mesh

    replicate_to_mesh(mesh, model)
    return _split_batches(lambda x: encode(x).float().cpu().numpy(), mesh)


def _split_batches(encode: Callable, mesh) -> Callable:
    """``encode`` over a mesh for full batches: every rank holds the batch,
    encodes its contiguous share of the rows
    (``pipelines/common.py::make_sharded_image_encoder``) and returns the
    whole batch's features."""
    from scd_tpu_torch.pipelines.common import (_pod_shard,
                                                make_sharded_image_encoder)

    sharded = make_sharded_image_encoder(encode, mesh)
    return lambda images: sharded(_pod_shard(np.asarray(images), mesh))


def _pad_tail(batch: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a ragged tail batch up to ``batch_size`` rows (tails are
    always <= one batch)."""
    batch = np.asarray(batch)
    n = batch.shape[0]
    target = -(-max(n, 1) // batch_size) * batch_size
    if target == n:
        return batch
    return np.pad(batch, [(0, target - n)] + [(0, 0)] * (batch.ndim - 1))


def iter_image_batches(path: str, batch_size: int, image_size: int = 224,
                       num_workers: int = 8):
    """Yield fixed-shape ``(images [batch_size, H, W, C], n_valid)`` pairs
    from ``--images``:

    - a ``.npy``/``.npz`` file: a pre-staged [B, H, W, C] array (npz: the
      ``images`` key, or the archive's single array);
    - a directory: the union of flat image files and imagefolder-layout
      subfolders (``<dir>/<class>/<image>``), decoded by the threaded
      loader (``data/loader.py``) with CLIP's eval preprocess, uint8 until
      the on-device normalize.

    Ragged tails are zero-padded to ``batch_size``; ``n_valid`` marks the
    real rows."""
    if os.path.isdir(path):
        from scd_tpu_torch.data import datasets
        from scd_tpu_torch.data.core import ImageTable
        from scd_tpu_torch.data.loader import iterate_batches
        from scd_tpu_torch.data.transforms import clip_preprocess

        # serve the union of flat files and <class>/ subfolder contents: a
        # mostly-flat directory with one stray subdir must not drop the
        # flat images, and vice versa
        sub_paths, sub_targets, _classes = datasets.scan_imagefolder(path)
        flat = sorted(f for f in os.listdir(path)
                      if f.lower().endswith(datasets.IMG_EXTENSIONS)
                      and os.path.isfile(os.path.join(path, f)))
        paths = np.concatenate([
            np.array([os.path.join(path, f) for f in flat], object),
            np.asarray(sub_paths, object)])
        targets = np.concatenate([np.full(len(flat), -1, np.int64),
                                  np.asarray(sub_targets, np.int64)])
        if len(paths) == 0:
            raise SystemExit(f"no images found under {path}")
        table = ImageTable(
            source=paths, targets=targets,
            uq_idxs=np.arange(len(paths), dtype=np.int64),
            classnames=[], load=lambda p: datasets._pil_loader(p),
            transform=clip_preprocess(image_size, device_normalize=True))
        for images, _labels, _uqs, _mask in iterate_batches(
                table, batch_size, num_workers=num_workers):
            yield _pad_tail(images, batch_size), len(images)
        return

    if path.endswith(".npz"):
        z = np.load(path)
        # the documented 'images' key, or any single-array archive
        # (np.savez(f, batch) stores under arr_0)
        key = "images" if "images" in z.files else z.files[0]
        images = z[key]
    else:
        images = np.load(path)
    for start in range(0, len(images), batch_size):
        batch = images[start:start + batch_size]
        yield _pad_tail(batch, batch_size), len(batch)


def _load_clip_variables(clip_weights: str, cfg):
    """An OpenAI checkpoint, or ``random``: weights drawn from a generator
    seeded with 0 (smoke / load-test mode: the full serving path,
    meaningless names).  Returns the Flax-layout tree."""
    from scd_tpu_torch.models import load_openai_clip_weights

    if clip_weights == "random":
        from scd_tpu_torch.testing.fabricate import clip_state_dict

        print("[infer] --clip_weights random: randomly-initialized CLIP "
              "(names are meaningless; smoke/load-test mode)",
              file=sys.stderr)
        return load_openai_clip_weights(clip_state_dict(cfg, seed=0), cfg)
    sd = torch.load(clip_weights, map_location="cpu")
    return load_openai_clip_weights(
        sd.state_dict() if hasattr(sd, "state_dict") else sd, cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description="Name images with a discovered "
                                            "vocabulary (serving path)")
    p.add_argument("--dataset_name", type=str, default="synthetic",
                   help="synthetic runs the asset-free smoke; otherwise "
                        "provide --clip_weights/--zeroshot_weights/--names")
    p.add_argument("--clip_weights", type=str, default="",
                   help="OpenAI CLIP checkpoint (.pt), or 'random' for a "
                        "randomly-initialized tower (smoke/load-test)")
    p.add_argument("--zeroshot_weights", type=str, default="",
                   help="npz/npy [D, K] (columns = --names order)")
    p.add_argument("--names", type=str, default="",
                   help="text file, one candidate name per line")
    p.add_argument("--images", type=str, default="",
                   help=".npy/.npz [B, H, W, C] batch, a directory of "
                        "image files, or an imagefolder "
                        "(<dir>/<class>/<image>)")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--image_size", type=int, default=0,
                   help="loader resize; 0 = the CLIP tower's native size. "
                        "A conflicting value is rejected up front (the "
                        "ViT pos-embed grid is size-specific).")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-axis size (0 = every launched rank; 1 "
                        "disables the mesh path; above the launched "
                        "ranks raises)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    args = p.parse_args(argv)
    from scd_tpu_torch.core.multihost import maybe_initialize, rank0_stdout

    dev = maybe_initialize(args.device)
    mesh = None
    if args.mesh_data != 1:
        from scd_tpu_torch.core.config import MeshConfig, PipelineConfig
        from scd_tpu_torch.pipelines.common import _pipeline_mesh

        mesh = _pipeline_mesh(PipelineConfig(
            mesh=MeshConfig(data=args.mesh_data, model=1)))
    with rank0_stdout():
        return _serve(args, dev, mesh)


def _serve(args, dev, mesh):

    if args.dataset_name == "synthetic":
        from scd_tpu_torch.core.config import DataConfig
        from scd_tpu_torch.data import get_datasets
        from scd_tpu_torch.models.synthetic import SyntheticCLIP
        from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights

        dcfg = DataConfig(dataset_name="synthetic")
        _m, test_ds, _u, extras = get_datasets(dcfg)
        clip = SyntheticCLIP(extras["class_colors"], device=dev)
        names = sorted(extras["class_colors"])
        w = build_zeroshot_weights(clip.encode_text, names, ["{}"])
        enc = clip.encode_image if mesh is None else _split_batches(
            clip.encode_image, mesh)
        clf = NameClassifier(enc, w, names, device=dev)
        imgs = np.stack([np.asarray(test_ds[i][0]) for i in range(16)])
        truth = [names[int(test_ds[i][1])] for i in range(16)]
        named, probs = clf.classify(imgs, topk=args.topk)
        acc = np.mean([t in row for t, row in zip(truth, named)])
        for row, pr in list(zip(named, probs))[:4]:
            print(f"pred: {row} p={np.round(pr, 3).tolist()}")
        print(f"top-{args.topk} accuracy on 16 synthetic test images: {acc}")
        return acc

    # real-asset path: bf16 compute, no int8 (the JAX package's recipe)
    from scd_tpu_torch.models import clip_vit_b16_config

    if not (args.clip_weights and args.zeroshot_weights and args.names
            and args.images):
        raise SystemExit("non-synthetic serving needs --clip_weights, "
                         "--zeroshot_weights, --names and --images")
    with open(args.names) as f:
        names = [line.rstrip("\n") for line in f]
    zw = (np.load(args.zeroshot_weights)["weights"]
          if args.zeroshot_weights.endswith(".npz")
          else np.load(args.zeroshot_weights))

    cfg = clip_vit_b16_config(compute_dtype=torch.bfloat16)
    image_size = args.image_size or cfg.vision.image_size
    if image_size != cfg.vision.image_size:
        raise SystemExit(
            f"--image_size {image_size} conflicts with the CLIP tower's "
            f"native {cfg.vision.image_size} (the ViT pos-embed grid is "
            "size-specific); omit the flag or pass the native size")
    enc = build_clip_encoder(
        _load_clip_variables(args.clip_weights, cfg), cfg,
        device=dev, mesh=mesh)
    clf = NameClassifier(enc, zw, names, device=dev)

    count, _ = serve_images(clf, args.images, args.batch_size, args.topk,
                            image_size=image_size,
                            num_workers=args.num_workers)
    return count


def serve_images(clf: NameClassifier, images: str, batch_size: int,
                 topk: int, image_size: int = 224, num_workers: int = 8):
    """Name every image of ``images`` (see :func:`iter_image_batches`),
    printing one line per image: its top-k names and probabilities.
    Returns (count, seconds of each batch): host clock around
    ``clf.classify``, which ends on the host."""
    count, batch_seconds = 0, []
    for batch, n in iter_image_batches(images, batch_size,
                                       image_size=image_size,
                                       num_workers=num_workers):
        t0 = time.perf_counter()
        named, probs = clf.classify(batch, topk=topk)
        batch_seconds.append(time.perf_counter() - t0)
        for row, pr in zip(named[:n], probs[:n]):
            print(f"{row}\t{np.round(pr, 4).tolist()}")
        count += n
    return count, batch_seconds


if __name__ == "__main__":
    main()
