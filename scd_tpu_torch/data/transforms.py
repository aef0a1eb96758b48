"""Image transforms: feature extraction and training.

Port of ``scd_tpu/data/transforms.py``: ``clip_preprocess`` and the
``device_normalize_*`` functions (CLIP's published eval transform, bicubic
resize of the short side, centre crop; with ``device_normalize=True`` it
emits uint8 HWC and the /255 + mean/std runs on the device, on the
batch), and :func:`get_transform`, the reference's train and eval
transforms of every family (``imagenet``, ``cifar``, ``cutout``,
``herbarium``, ``rand_aug``), with the same generator draws in the same
order, so one seed gives the same arrays in both packages.

PIL is imported only where an image really changes size or goes through a
PIL op.  The transforms work on uint8 HWC arrays, and a resize to the size
an array already has, or a crop inside it, is done in numpy: PIL returns
an unchanged copy for the one and a slice for the other, so the arrays
are those PIL would give.  An image that is already a uint8 array at the
size a transform resizes to therefore needs no PIL (``clip_preprocess``
at its output size; the ``imagenet`` family at ``image_size /
crop_pct``).
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _ensure_pil(img):
    """PIL images, or HWC arrays (synthetic datasets yield arrays)."""
    from PIL import Image

    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr,
                      0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def _resize_short(img, size: int):
    from PIL import Image

    w, h = img.size
    if w < h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), Image.BICUBIC)


def _center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _is_final_uint8(img, size: int) -> bool:
    return (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.shape == (size, size, 3))


def clip_preprocess(image_size: int = 224, device_normalize: bool = False):
    """CLIP's published eval preprocess (see the module docstring)."""

    def fn(img) -> np.ndarray:
        if device_normalize and _is_final_uint8(img, image_size):
            return img
        img = _center_crop(_resize_short(_ensure_pil(img), image_size),
                           image_size)
        if device_normalize:
            return np.asarray(img.convert("RGB"), np.uint8)
        x = np.asarray(img.convert("RGB"), np.float32) / 255.0
        return (x - CLIP_MEAN) / CLIP_STD

    return fn


def _device_normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """/255 + mean/std for uint8 batches, on their device; identity for
    float inputs (already normalized on the host)."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - mean) / std


def device_normalize_clip(x: torch.Tensor) -> torch.Tensor:
    """CLIP statistics (the mains' preprocess)."""
    return _device_normalize(x, CLIP_MEAN, CLIP_STD)


def device_normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """torchvision ImageNet statistics."""
    return _device_normalize(x, IMAGENET_MEAN, IMAGENET_STD)


def device_normalize_unit(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] scaling with no mean/std shift (timm's miil ViT)."""
    return _device_normalize(x, np.float32(0.0), np.float32(1.0))


# ----------------------------------------------------- training transforms
# (reference ``gcd/data/augmentations/__init__.py:5-107``)

def _rgb(img) -> np.ndarray:
    """uint8 [H, W, 3] of a PIL image or an HWC array, as
    ``_ensure_pil(img).convert("RGB")`` gives it."""
    if isinstance(img, np.ndarray) and img.ndim == 3 and img.shape[2] == 3:
        if img.dtype == np.uint8:
            return img
        return np.clip(img * 255.0 if img.max() <= 1.0 + 1e-6 else img,
                       0, 255).astype(np.uint8)
    return np.asarray(_ensure_pil(img).convert("RGB"), np.uint8)


def _resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """PIL's bicubic resize of a uint8 RGB array to (w, h)."""
    if arr.shape[1] == w and arr.shape[0] == h:
        return arr
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize((w, h), Image.BICUBIC),
                      np.uint8)


def _resize_short_array(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    if w < h:
        return _resize(arr, size, max(1, round(h * size / w)))
    return _resize(arr, max(1, round(w * size / h)), size)


def _crop(arr: np.ndarray, left: int, top: int, right: int,
          bottom: int) -> np.ndarray:
    """PIL's crop: a slice inside the image, zeros outside it."""
    h, w = arr.shape[:2]
    if 0 <= left <= right <= w and 0 <= top <= bottom <= h:
        return arr[top:bottom, left:right]
    from PIL import Image

    return np.asarray(Image.fromarray(arr).crop((left, top, right, bottom)),
                      np.uint8)


def _center_crop_array(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    return _crop(arr, left, top, left + size, top + size)


def _normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (x - mean) / std


def _rand_resized_crop(arr: np.ndarray, size: int, rng: np.random.Generator,
                       scale=(0.3, 1.0)) -> np.ndarray:
    """RandomResizedCrop on a uint8 RGB array (ten tries, then the centre
    crop of the short-side resize)."""
    h, w = arr.shape[:2]
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            left = rng.integers(0, w - cw + 1)
            top = rng.integers(0, h - ch + 1)
            return _resize(np.ascontiguousarray(
                _crop(arr, left, top, left + cw, top + ch)), size, size)
    return _center_crop_array(_resize_short_array(arr, size), size)


def _padded_random_crop(arr: np.ndarray, size: int, pad: int,
                        rng) -> np.ndarray:
    """torchvision RandomCrop(size, padding=pad) over a uint8 HWC array."""
    if pad:
        arr = np.pad(arr, ((pad, pad), (pad, pad), (0, 0)), mode="constant")
    top = int(rng.integers(0, max(arr.shape[0] - size, 0) + 1))
    left = int(rng.integers(0, max(arr.shape[1] - size, 0) + 1))
    return arr[top:top + size, left:left + size]


def get_transform(name: str = "imagenet", image_size: int = 224,
                  crop_pct: float = 0.875, train: bool = False,
                  seed: int = 0, rand_aug: "tuple | None" = None,
                  cutout_p: float = 1.0,
                  herbarium_lower_bound: float = 0.5):
    """Train and eval transforms per family, as the JAX package's:

    - ``imagenet``: Resize(size / crop_pct) + RandomCrop + flip, ImageNet
      statistics (the reference's ColorJitter() is a no-op);
    - ``cifar``: RandomCrop(pad 4) + flip, pytorch-cifar statistics;
    - ``cutout``: RandomCrop(pad 4) + flip + a half-size cutout, CIFAR mean
      with the cutout family's 0.2470 / 0.2435 / 0.2616 std;
    - ``herbarium``: square resize + RandomResizedCrop(scale (lb, 1)) +
      flip, no normalization;
    - ``rand_aug=(n, m)``: RandAugment, square resize, RandomCrop(pad 4),
      flip, ImageNet statistics.

    Eval: square resize (cifar, cutout, herbarium) or short-side resize +
    centre crop (imagenet).  Outputs float32 HWC.  Randomness comes from
    per-thread seeded generators (``augment.ThreadRng``), as the loaders
    map transforms across thread pools."""
    if name not in ("imagenet", "cifar", "herbarium", "cutout"):
        raise ValueError(f"unknown transform family {name!r}")
    from scd_tpu_torch.data.augment import ThreadRng

    mean, std = IMAGENET_MEAN, IMAGENET_STD
    if name == "cifar":  # pytorch-cifar statistics
        mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
        std = np.array([0.2023, 0.1994, 0.2010], np.float32)
    elif name == "cutout":  # the cutout family's own
        mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
        std = np.array([0.2470, 0.2435, 0.2616], np.float32)
    thread_rng = ThreadRng(seed)

    if not train:
        def eval_fn(img) -> np.ndarray:
            arr = _rgb(img)
            if name in ("cifar", "cutout", "herbarium"):
                arr = _resize(arr, image_size, image_size)
            else:
                arr = _center_crop_array(
                    _resize_short_array(arr, int(image_size / crop_pct)),
                    image_size)
            x = arr.astype(np.float32) / 255.0
            if name == "herbarium":  # the reference stops at ToTensor
                return x
            return _normalize(x, mean, std)

        return eval_fn

    if name in ("cifar", "cutout"):
        cut = None
        if name == "cutout":
            from scd_tpu_torch.data.augment import cutout
            cut = cutout(mask_size=image_size // 2, p=cutout_p,
                         cutout_inside=False, seed=seed)

        def cifar_train_fn(img) -> np.ndarray:
            rng = thread_rng.get()
            arr = _padded_random_crop(_rgb(img), image_size, 4, rng)
            x = arr.astype(np.float32) / 255.0
            if rng.random() < 0.5:
                x = x[:, ::-1]
            x = _normalize(np.ascontiguousarray(x), mean, std)
            if cut is not None:
                x = cut(x)
            return x

        return cifar_train_fn

    if name == "herbarium":
        def herbarium_train_fn(img) -> np.ndarray:
            rng = thread_rng.get()
            arr = _resize(_rgb(img), image_size, image_size)
            arr = _rand_resized_crop(arr, image_size, rng,
                                     scale=(herbarium_lower_bound, 1.0))
            x = arr.astype(np.float32) / 255.0
            if rng.random() < 0.5:
                x = x[:, ::-1]
            return np.ascontiguousarray(x)

        return herbarium_train_fn

    randaug = None
    if rand_aug is not None:
        from scd_tpu_torch.data.augment import RandAugment
        randaug = RandAugment(int(rand_aug[0]), int(rand_aug[1]), seed=seed)

    def train_fn(img) -> np.ndarray:
        rng = thread_rng.get()
        arr = _rgb(img)
        if randaug is not None:
            from PIL import Image

            arr = np.asarray(randaug(Image.fromarray(arr)), np.uint8)
            arr = _resize(arr, image_size, image_size)
            arr = _padded_random_crop(arr, image_size, 4, rng)
        else:
            arr = _resize_short_array(arr, int(image_size / crop_pct))
            arr = _padded_random_crop(arr, image_size, 0, rng)
        x = arr.astype(np.float32) / 255.0
        if rng.random() < 0.5:
            x = x[:, ::-1]
        return _normalize(np.ascontiguousarray(x), mean, std)

    return train_fn
