"""Image preprocessing for feature extraction.

Port of ``clip_preprocess`` and the ``device_normalize_*`` functions of
``scd_tpu/data/transforms.py`` (the train augmentations come later).
``clip_preprocess`` is CLIP's published eval transform (bicubic resize of
the short side, centre crop); with ``device_normalize=True`` it emits
uint8 HWC and the /255 + mean/std runs on the device, on the batch
(``device_normalize_clip``).  PIL is imported inside the transform, so the
module imports on a machine without it; an image that is already a uint8
``[S, S, 3]`` array at the target size passes through unchanged (PIL's
resize and crop at that size are the identity), which needs no PIL.
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
