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

Tensor parallelism (a ``model`` mesh axis in the trainers): the
counterpart of the JAX package's ``_tp_spec`` (``scd_tpu/train/gcd.py:
113-125``) by the same names.  :func:`tp_layout` says how a parameter
splits, :func:`shard_state_dict` cuts a full state dict to one rank and
:func:`gather_state_dict` (every rank of the group) puts the full tensors
back, its exact inverse.  The packed qkv is cut by heads, not by columns:
a rank's slice is ``[q | k | v]`` of its own ``H / tp`` heads, the layout
``ops.attention._heads`` reads, where the JAX spec's contiguous column
split would give rank 0 all of q and half of k.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

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


def tp_layout(name: str, shape) -> Optional[str]:
    """How the tensor-parallel layers split the parameter ``name`` of
    ``shape`` over the ``model`` axis (``_tp_spec``'s rules):

    - ``"qkv"``: a packed qkv kernel [D, 3W] or bias [3W], each of q, k, v
      cut into contiguous head groups on its last axis;
    - ``"cols"``: an ``fc1`` kernel [D, F] or bias [F], by columns;
    - ``"rows"``: a ``proj`` or ``fc2`` kernel [F, D], by rows (its bias
      stays whole: it is added once, after the reduction);
    - None: replicated (everything else, the stacked heads' [H, ...]
      parameters too)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    layer, leaf = parts[-2], parts[-1]
    if leaf == "kernel" and len(shape) == 2:
        return {"qkv": "qkv", "fc1": "cols", "proj": "rows",
                "fc2": "rows"}.get(layer)
    if leaf == "bias" and len(shape) == 1:
        return {"qkv": "qkv", "fc1": "cols"}.get(layer)
    return None


def _qkv_split(t: torch.Tensor) -> torch.Tensor:
    return t.unflatten(-1, (3, t.shape[-1] // 3))


def shard_tensor(name: str, t: torch.Tensor, size: int,
                 index: int) -> torch.Tensor:
    """Rank ``index``'s part (of ``size``) of the full parameter ``name``
    (:func:`tp_layout`), a tensor of its own; a replicated parameter is
    returned as it is.  The split axis must divide by ``size``."""
    kind = tp_layout(name, t.shape)
    if kind is None or size == 1:
        return t
    src = _qkv_split(t) if kind == "qkv" else t
    dim = 0 if kind == "rows" else -1
    n = src.shape[dim]
    if n % size:
        raise ValueError(f"{name}: {n} does not split over {size} ranks "
                         "of the 'model' axis")
    part = src.narrow(dim, index * (n // size), n // size)
    return (part.flatten(-2) if kind == "qkv" else part).clone(
        memory_format=torch.contiguous_format)


def unshard_tensor(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The full parameter ``name`` from every rank's part, in rank order:
    the exact inverse of :func:`shard_tensor`."""
    kind = tp_layout(name, parts[0].shape)
    if kind is None or len(parts) == 1:
        return parts[0]
    if kind == "qkv":
        return torch.cat([_qkv_split(p) for p in parts], -1).flatten(-2)
    return torch.cat(parts, 0 if kind == "rows" else -1)


def shard_state_dict(state: Dict[str, torch.Tensor],
                     tp) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank of ``tp`` (a
    ``core.mesh.ModelGroup``; None returns ``state``)."""
    if tp is None:
        return state
    return {k: shard_tensor(k, v, tp.size, tp.index)
            for k, v in state.items()}


def gather_tensor(name: str, t: torch.Tensor, tp) -> torch.Tensor:
    """The full parameter ``name`` from this rank's part: one
    ``all_gather`` over ``tp``'s group (every rank of it calls), then
    :func:`unshard_tensor`.  A replicated parameter is returned as it
    is."""
    if tp is None or tp_layout(name, t.shape) is None:
        return t
    from scd_tpu_torch.core.multihost import all_gather

    return unshard_tensor(name, all_gather(t.detach().contiguous(),
                                           group=tp.group))


def gather_state_dict(state: Dict[str, torch.Tensor],
                      tp) -> Dict[str, torch.Tensor]:
    """The full state dict on every rank of ``tp`` from each rank's
    shards (every rank of the group calls, with the same keys in the same
    order)."""
    if tp is None:
        return state
    return {k: gather_tensor(k, v, tp) for k, v in state.items()}


def shard_module(full: nn.Module, make_local: Callable[[], nn.Module],
                 tp) -> nn.Module:
    """``make_local()`` (the module built under ``tp``, its tensor-parallel
    parameters at their shard shapes) loaded with this rank's shard of
    ``full``'s parameters; ``full`` itself when ``tp`` is None.  Every
    rank builds ``full`` from the same seed, as every JAX host builds
    identical parameters, and keeps its part."""
    if tp is None:
        return full
    local = make_local()
    local.load_state_dict(shard_state_dict(full.state_dict(), tp))
    return local


def tp_bytes(module: nn.Module) -> int:
    """Bytes of ``module``'s parameters that the tensor-parallel layers
    split (whole on one process, a rank's part under a ``model`` axis)."""
    return sum(p.numel() * p.element_size()
               for n, p in module.named_parameters()
               if tp_layout(n, p.shape) is not None)
