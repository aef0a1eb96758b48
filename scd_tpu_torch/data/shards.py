"""Packed pre-decoded uint8 image shards — the ingest-proof dataset format.

Port of ``scd_tpu/data/shards.py``, with the same on-disk layout, so
either package reads the shards the other wrote.  Decode is a one-time
cost: shards hold already-decoded, already-preprocessed uint8 images,
streamed back with no per-image Python work and normalized on the device,
so only uint8 crosses the host->device link.

Layout (npz's zip CRC32 caps reads at ~550 imgs/s on one core; mmap'd raw
``.npy`` batches slice at >16k imgs/s from page cache, as measured for
the JAX package on its host):

- ``shard_NNNNN.npy``   raw uint8 [S, H, W, C], read with mmap_mode='r'
  (per-batch slices memcpy from the page cache; the OS readahead streams
  the file — no decompression, no checksum, no per-image work);
- ``meta.npz``          labels / uq_idxs / mask_lab for the WHOLE set
  (~17 bytes/image — trivial);
- ``shards.json``       manifest (shard files, sizes, image shape).

Write once with :func:`write_image_shards` (any batch iterator, e.g.
``iterate_batches`` over the JPEG tree), then feed extraction from
:func:`iterate_shard_batches` — same (images, labels, uq_idxs, mask_lab)
batch contract as ``data.loader.iterate_batches``.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

_MANIFEST = "shards.json"
_META = "meta.npz"


def write_image_shards(batches, out_dir: str, shard_size: int = 2048) -> str:
    """Repack a batch iterator (images [B,H,W,C] uint8, labels, uq_idxs,
    mask_lab) into ``shard_size``-image raw-npy shards + one meta.npz +
    a manifest.  Images must already be uint8 (the eval preprocess emits
    uint8 for on-device normalization); float batches are rejected rather
    than silently re-quantized.  Returns the manifest path."""
    os.makedirs(out_dir, exist_ok=True)
    buf_imgs = []
    labels_all, uqs_all, mask_all = [], [], []
    shards = []
    count = 0
    shape = None

    def buffered():
        return sum(len(b) for b in buf_imgs)

    def flush():
        nonlocal buf_imgs
        if not buf_imgs:
            return
        images = np.concatenate(buf_imgs)
        name = f"shard_{len(shards):05d}.npy"
        tmp = os.path.join(out_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            np.save(f, images)
        os.replace(tmp, os.path.join(out_dir, name))
        shards.append({"file": name, "n": int(len(images))})
        buf_imgs = []

    for images, labels, uqs, mask in batches:
        images = np.asarray(images)
        if images.dtype != np.uint8:
            raise ValueError(
                f"shards store uint8 images (got {images.dtype}); use the "
                "uint8-emitting eval preprocess (clip_preprocess with "
                "device_normalize=True)")
        shape = images.shape[1:]
        labels_all.append(np.asarray(labels, np.int64))
        uqs_all.append(np.asarray(uqs, np.int64))
        mask_all.append(np.asarray(mask, bool))
        start = 0
        while start < len(images):
            take = min(len(images) - start, shard_size - buffered())
            buf_imgs.append(images[start:start + take])
            count += take
            start += take
            if buffered() >= shard_size:
                flush()
    flush()
    np.savez(os.path.join(out_dir, _META),
             labels=np.concatenate(labels_all) if labels_all else
             np.zeros(0, np.int64),
             uq_idxs=np.concatenate(uqs_all) if uqs_all else
             np.zeros(0, np.int64),
             mask_lab=np.concatenate(mask_all) if mask_all else
             np.zeros(0, bool))
    manifest = {"n_images": count, "image_shape": list(shape or ()),
                "shard_size": shard_size, "shards": shards}
    path = os.path.join(out_dir, _MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def shard_manifest(shard_dir: str) -> dict:
    with open(os.path.join(shard_dir, _MANIFEST)) as f:
        return json.load(f)


def iterate_shard_batches(shard_dir: str, batch_size: int,
                          readahead: int = 2,
                          process_shard: Optional[Tuple[int, int]] = None
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]]:
    """Stream (images uint8, labels, uq_idxs, mask_lab) batches from a
    shard directory — the drop-in ingest-proof replacement for
    ``iterate_batches`` over a JPEG tree.  Images mmap per shard and each
    batch is one contiguous memcpy out of the page cache; a readahead
    thread overlaps that with device compute.

    ``process_shard=(index, count)``: yield only this process's contiguous
    slice of the shard list (multi-controller extraction: each host reads
    only its own shards — the pod contract of the JAX package's
    ``pipelines/common.py::extract_features_pod``).
    """
    from scd_tpu_torch.data.loader import _readahead_iter

    man = shard_manifest(shard_dir)
    shards = man["shards"]
    offsets = np.cumsum([0] + [s["n"] for s in shards])
    with np.load(os.path.join(shard_dir, _META)) as z:
        meta = (z["labels"], z["uq_idxs"], z["mask_lab"])
    if process_shard is not None:
        idx, cnt = process_shard
        share = -(-len(shards) // cnt)
        lo, hi = idx * share, min((idx + 1) * share, len(shards))
        shards = shards[lo:hi]
        offsets = offsets[lo:hi + 1] if lo < len(offsets) else offsets[:0]

    def gen():
        carry = None  # tail of the previous shard, glued across shards
        for si, entry in enumerate(shards):
            arr = np.load(os.path.join(shard_dir, entry["file"]),
                          mmap_mode="r")
            base = offsets[si]
            block = (arr, *(m[base:base + entry["n"]] for m in meta))
            if carry is not None:
                block = tuple(np.concatenate([c, b])
                              for c, b in zip(carry, block))
                carry = None
            n = len(block[0])
            start = 0
            while n - start >= batch_size:
                # np.array COPY, not a view: ascontiguousarray on a
                # contiguous mmap slice is lazy (no page is read until the
                # consumer touches it), which would defeat the readahead
                # thread — the copy faults the pages HERE, in the
                # producer, overlapping disk IO with device compute
                yield tuple(np.array(a[start:start + batch_size])
                            for a in block)
                start += batch_size
            if start < n:
                carry = tuple(np.array(a[start:]) for a in block)
        if carry is not None:
            yield carry

    if readahead <= 0:
        return gen()
    return _readahead_iter(gen(), readahead)
