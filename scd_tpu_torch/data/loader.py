"""Batch iteration: dataset -> numpy NHWC batches with threaded decode.

Port of ``scd_tpu/data/loader.py``.  A thread pool decodes and transforms
images while the device consumes the previous batch; batches are
contiguous NHWC arrays (uint8 kept as uint8, so the device normalizes
them).  Order is deterministic (sequential, like the reference's
``shuffle=False`` extraction loaders) unless a shuffle seed is given.
With ``readahead > 0`` a producer thread keeps up to that many batches
decoded ahead of the consumer (torch DataLoader's ``prefetch_factor``).
"""

from __future__ import annotations

import queue as _queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple


import numpy as np


def _readahead_iter(gen, depth: int):
    """Drive ``gen`` from a daemon thread, buffering up to ``depth`` items.

    Exceptions raised by the producer re-raise in the consumer; an
    early-exiting consumer (``break``) sets a stop flag the producer polls
    on every (timeout) put, so the thread never leaks."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def run():
        try:
            for item in gen:
                if not _put(("item", item)):
                    return
            _put(("end", None))
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            _put(("err", e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                return
            if kind == "err":
                raise payload
            yield payload
    finally:
        stop.set()


def iterate_batches(dataset, batch_size: int, num_workers: int = 8,
                    shuffle_seed: Optional[int] = None,
                    drop_last: bool = False,
                    readahead: int = 2) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield (images [B,H,W,C] f32, labels [B] i64, uq_idxs [B] i64,
    mask_lab [B] bool) batches from a MergedDataset-contract dataset.

    3-tuple datasets (no labelled mask) yield mask_lab = zeros.
    ``readahead`` batches are decoded ahead of the consumer by a producer
    thread (0 disables the pipeline and decodes inline).
    """
    gen = _iterate_batches_sync(dataset, batch_size, num_workers,
                                shuffle_seed, drop_last)
    if readahead <= 0:
        return gen
    return _readahead_iter(gen, readahead)


def _iterate_batches_sync(dataset, batch_size: int, num_workers: int,
                          shuffle_seed: Optional[int],
                          drop_last: bool) -> Iterator[Tuple[np.ndarray, ...]]:
    n = len(dataset)
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)

    def fetch(i: int):
        item = dataset[int(i)]
        if len(item) == 4:
            img, label, uq, lab = item
            return img, label, uq, int(np.asarray(lab).reshape(-1)[0])
        img, label, uq = item
        return img, label, uq, 0

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, n, batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            items = list(pool.map(fetch, idxs))
            first = np.asarray(items[0][0])
            # preserve uint8 batches: the device-normalize path ships 4x
            # fewer bytes over the (slow) host->device link and applies
            # mean/std on device
            batch_dtype = np.uint8 if first.dtype == np.uint8 else np.float32
            images = np.stack([np.asarray(it[0], batch_dtype)
                               for it in items])
            labels = np.array([it[1] for it in items], np.int64)
            uqs = np.array([it[2] for it in items], np.int64)
            mask = np.array([it[3] for it in items], bool)
            yield images, labels, uqs, mask
