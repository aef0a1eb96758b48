"""Parameter trees into the towers.

The towers name their parameters by the Flax tree's paths
(``block_0.attn.qkv.kernel``) and keep its layouts, so a Flax parameter
tree (the JAX package's model variables, or what the checkpoint loaders of
both packages return) maps onto a tower's state dict by joining the path
with dots.  It is the counterpart, for weights, of
``core.cache.tensors_from_arrays``.

:func:`flax_init_` gives a freshly built model Flax's default
initializers, drawn from a ``torch.Generator`` (the JAX package draws
from ``jax.random``, so the values differ; the distributions are the
same).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

# Flax's variance_scaling truncates at +-2 sigma and divides the stddev
# by this (the std of a unit normal truncated there), so the kept samples
# have variance scale / fan_in
_TRUNC_STD = 0.87962566103423978


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


def flax_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Give every parameter of ``module`` (its towers' and heads' Flax
    names) Flax's default initializer, in ``named_parameters`` order from
    one CPU ``torch.Generator(seed)``, then copy it in place (so the values
    do not depend on the module's device):

    - ``kernel`` (Dense ``[in, out]``, Conv ``[kh, kw, in, out]``):
      ``lecun_normal``, a normal truncated at +-2 sigma whose samples have
      variance 1 / fan_in (fan_in: every axis but the last);
    - ``bias``, ``cls_token``: zeros; a LayerNorm's or GroupNorm's
      ``scale``: ones;
    - ``pos_embed``, ``last_layer``, ``prototypes``: normal(0.02); a CLIP
      tower's ``proj`` [width, out]: normal(width ** -0.5).

    A parameter under a module named ``Vmap_*`` (``nn.vmap``'s name, as in
    the UNO heads) is a stack over its leading axis of per-member
    parameters, each drawn as above: a kernel ``[H, in, out]`` has fan_in
    ``in``.

    Returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            path = name.split(".")
            leaf = path[-1]
            stacked = any(k.startswith("Vmap_") for k in path[:-1])
            v = torch.empty(p.shape, dtype=torch.float32)
            if leaf == "kernel":
                fan_in = math.prod(p.shape[1 if stacked else 0:-1])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)
            elif leaf in ("bias", "cls_token"):
                v.zero_()
            elif leaf == "scale":
                v.fill_(1.0)
            elif leaf in ("pos_embed", "last_layer", "prototypes"):
                v.normal_(0.0, 0.02, generator=gen)
            elif leaf == "proj":
                v.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
            else:
                raise ValueError(f"no Flax initializer known for {name!r}")
            p.copy_(v)
    return module
