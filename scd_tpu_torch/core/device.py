"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` unless the caller asks for the CPU.
A CUDA request without a card raises: nothing falls back to the CPU.

TF32 is switched off on every path that is held against the JAX package.
The JAX package keeps f32-class matmuls on purpose (``ops/distance.py``,
``ops/topk.py``): a single bf16 or TF32 pass perturbs logits and distances
by ~1e-3 relative, enough to flip near-tie argmins and name rankings.
"""

from __future__ import annotations

import torch


def f32_matmuls() -> None:
    """Full-f32 matmuls and convolutions (no TF32) for this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no card is present.  Also switches TF32 off (see module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    f32_matmuls()
    return dev
