"""RandAugment, Cutout, and the contrastive view generator.

Port of ``scd_tpu/data/augment.py``, draw for draw: the same generator
calls in the same order, so one seed gives the same arrays in both
packages.  PIL is imported inside the ops that need it, so the module
imports where PIL is missing; ``cutout`` and ``ContrastiveViewGenerator``
need none.  References: ``gcd/data/augmentations/randaugment.py`` (the
EfficientNet-policy 16-op bank, :186-205, and the ``RandAugment(n, m)``
magnitude convention ``val = m/30*(max-min)+min``, :289-293),
``gcd/data/augmentations/cut_out.py`` (randomly-placed square mask),
``learn_metric.py:172-181`` (``ContrastiveLearningViewGenerator``).

Host-side PIL/numpy ops: augmentation feeds the input pipeline on the host
and the device sees only the final float batches.  All randomness flows through
an explicit ``np.random.Generator`` — the reference uses the global
``random`` module, which is unreproducible across workers.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class ThreadRng:
    """Per-thread ``np.random.Generator`` factory.

    numpy Generators are NOT thread-safe, and the loaders map transforms
    across a ``ThreadPoolExecutor`` — one shared generator either corrupts
    its bit-generator state or hands racing threads identical draws
    (duplicate crops/flips).  Each thread gets its own generator seeded
    ``(seed, thread_index)``; runs are bit-reproducible per thread, and
    exactly reproducible end-to-end at ``num_workers=1``.
    """

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._local = threading.local()
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def get(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                k = next(self._counter)
            rng = np.random.default_rng((self._seed, k))
            self._local.rng = rng
        return rng


# ------------------------------------------------------------- op bank
# Geometric ops negate their magnitude with p=0.5, exactly like the
# reference bank (``randaugment.py:13-62`` — without it every rotation
# spins one way and every shear/translate pushes one fixed direction).

def _shear_x(img, v, rng):
    from PIL import Image
    if rng.random() > 0.5:
        v = -v
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, v, rng):
    from PIL import Image
    if rng.random() > 0.5:
        v = -v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x_abs(img, v, rng):
    from PIL import Image
    if rng.random() > 0.5:
        v = -v
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y_abs(img, v, rng):
    from PIL import Image
    if rng.random() > 0.5:
        v = -v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


def _rotate(img, v, rng):
    if rng.random() > 0.5:
        v = -v
    return img.rotate(v)


def _auto_contrast(img, _v, _rng):
    from PIL import ImageOps
    return ImageOps.autocontrast(img)


def _invert(img, _v, _rng):
    from PIL import ImageOps
    return ImageOps.invert(img)


def _equalize(img, _v, _rng):
    from PIL import ImageOps
    return ImageOps.equalize(img)


def _solarize(img, v, _rng):
    from PIL import ImageOps
    return ImageOps.solarize(img, v)


def _solarize_add(img, addition, _rng, threshold=128):
    from PIL import Image, ImageOps
    # reference SolarizeAdd (randaugment.py:86-93): add to ALL pixels,
    # clip, THEN solarize at the threshold (inverting bright pixels) —
    # not an add restricted to the below-threshold range
    arr = np.clip(np.asarray(img).astype(np.int64) + int(addition),
                  0, 255).astype(np.uint8)
    return ImageOps.solarize(Image.fromarray(arr), threshold)


def _posterize(img, v, _rng):
    from PIL import ImageOps
    return ImageOps.posterize(img, max(1, int(v)))


def _color(img, v, _rng):
    from PIL import ImageEnhance
    return ImageEnhance.Color(img).enhance(v)


def _contrast(img, v, _rng):
    from PIL import ImageEnhance
    return ImageEnhance.Contrast(img).enhance(v)


def _brightness(img, v, _rng):
    from PIL import ImageEnhance
    return ImageEnhance.Brightness(img).enhance(v)


def _sharpness(img, v, _rng):
    from PIL import ImageEnhance
    return ImageEnhance.Sharpness(img).enhance(v)


def _cutout_abs(img, v, rng: Optional[np.random.Generator] = None):
    # the reference (randaugment.py:129-147) fills an ImageDraw.rectangle
    # with FLOAT corners — rectangle coordinates truncate and the fill is
    # INCLUSIVE of (x1, y1), one row/col wider than an int-sized paste;
    # reproduce that exactly
    if v < 0:
        return img
    if rng is None:  # direct callers without a generator
        rng = np.random.default_rng()
    w, h = img.size
    x0 = int(max(0, rng.uniform(0, w) - v / 2.0))
    y0 = int(max(0, rng.uniform(0, h) - v / 2.0))
    x1 = min(w, x0 + v)
    y1 = min(h, y0 + v)
    img = img.copy()
    from PIL import ImageDraw
    ImageDraw.Draw(img).rectangle((x0, y0, x1, y1), (125, 123, 114))
    return img


# (op, minval, maxval) — the EfficientNet/AutoAugment policy bank used by
# the reference (``randaugment.py:186-205``).
AUGMENT_LIST: List[Tuple[Callable, float, float]] = [
    (_auto_contrast, 0, 1),
    (_equalize, 0, 1),
    (_invert, 0, 1),
    (_rotate, 0, 30),
    (_posterize, 0, 4),
    (_solarize, 0, 256),
    (_solarize_add, 0, 110),
    (_color, 0.1, 1.9),
    (_contrast, 0.1, 1.9),
    (_brightness, 0.1, 1.9),
    (_sharpness, 0.1, 1.9),
    (_shear_x, 0.0, 0.3),
    (_shear_y, 0.0, 0.3),
    (_cutout_abs, 0, 40),
    (_translate_x_abs, 0.0, 100),
    (_translate_y_abs, 0.0, 100),
]


class RandAugment:
    """Apply ``n`` ops sampled from the bank at magnitude ``m`` in [0, 30]
    (reference ``RandAugment.__call__``, ``randaugment.py:289-293``)."""

    def __init__(self, n: int, m: int, seed: int = 0,
                 augment_list: Optional[Sequence] = None):
        self.n = n
        self.m = m
        self._rng = ThreadRng(seed)
        self.augment_list = list(augment_list or AUGMENT_LIST)

    def __call__(self, img: Image.Image) -> Image.Image:
        rng = self._rng.get()
        idxs = rng.integers(0, len(self.augment_list), size=self.n)
        for i in idxs:
            op, minval, maxval = self.augment_list[int(i)]
            val = (float(self.m) / 30.0) * float(maxval - minval) + minval
            img = op(img, val, rng)
        return img


def cutout(mask_size: int, p: float, cutout_inside: bool,
           mask_color=(0, 0, 0), seed: int = 0):
    """Array-level cutout closure (reference ``cut_out.py:8-40``): with
    probability ``p`` zero a ``mask_size``² square at a random center."""
    thread_rng = ThreadRng(seed)
    half = mask_size // 2
    offset = 1 if mask_size % 2 == 0 else 0

    def _cutout(image):
        rng = thread_rng.get()
        image = np.asarray(image).copy()
        if rng.random() > p:
            return image
        h, w = image.shape[:2]
        if cutout_inside:
            cxmin, cxmax = half, w + offset - half
            cymin, cymax = half, h + offset - half
        else:
            cxmin, cxmax = 0, w + offset
            cymin, cymax = 0, h + offset
        cx = int(rng.integers(cxmin, max(cxmax, cxmin + 1)))
        cy = int(rng.integers(cymin, max(cymax, cymin + 1)))
        xmin, ymin = max(0, cx - half), max(0, cy - half)
        xmax, ymax = min(w, cx - half + mask_size), min(h, cy - half + mask_size)
        image[ymin:ymax, xmin:xmax] = mask_color
        return image

    return _cutout


class ContrastiveViewGenerator:
    """Return ``n_views`` independent augmentations of one image (reference
    ``ContrastiveLearningViewGenerator``, ``learn_metric.py:172-181``)."""

    def __init__(self, base_transform: Callable, n_views: int = 2):
        self.base_transform = base_transform
        self.n_views = n_views

    def __call__(self, x) -> List:
        return [self.base_transform(x) for _ in range(self.n_views)]
