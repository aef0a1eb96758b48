"""Parameter trees into the towers.

The towers name their parameters by the Flax tree's paths
(``block_0.attn.qkv.kernel``) and keep its layouts, so a Flax parameter
tree (the JAX package's model variables, or what the checkpoint loaders of
both packages return) maps onto a tower's state dict by joining the path
with dots.  It is the counterpart, for weights, of
``core.cache.tensors_from_arrays``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (nested dicts of arrays, with or without the
    top-level ``"params"`` collection) -> a flat state dict of f32 CPU
    tensors for ``module.load_state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix: str) -> None:
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
            else:
                out[name] = torch.from_numpy(
                    np.array(v, dtype=np.float32, copy=True))

    walk(tree, "")
    return out
