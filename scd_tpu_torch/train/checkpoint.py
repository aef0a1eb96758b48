"""Checkpoint and resume for training loops.

Port of ``scd_tpu/train/checkpoint.py`` (reference behaviour,
``gcd/methods/metric_learn/learn_metric.py:320-338``: ``model.pt`` and the
projection head every epoch, ``model_best.pt`` whenever old-class test ACC
improves; like the JAX package, optimizer state and the step counter are
kept too, so training resumes).

Same retention (``keep`` newest steps, the best kept aside), best-metric
tracking, JSON sidecars (``ckpt_<step>.json``: step and metrics) and
``manifest.json`` (steps, best step and value) as the JAX package.  The
blob differs: the JAX package writes one flax msgpack per step
(``ckpt_<step>.msgpack``), which needs flax; the port writes
``ckpt_<step>.pt``, a ``torch.save`` of the state it is given (a trainer's
model, head and optimizer state dicts plus the step), with every tensor
moved to the host.  The port does not read the JAX package's blobs, nor
the JAX package the port's.

Over several ranks (``core.multihost``; data-parallel training holds the
same state on every rank) every rank calls :meth:`CheckpointManager.save`
and keeps the manifest in memory, rank 0 alone writes and prunes the
files, and a ``barrier`` after each save publishes them before any rank
reads on, as ``core/cache.py`` does.  Under a ``model`` axis (tensor
parallelism) the trainers hand it full tensors, gathered over the model
group, the optimizer's momentum included
(:func:`gather_optimizer_state`), so rank 0's ``ckpt_<step>.pt``
restores into one process, and back into a tensor-parallel run through
:func:`shard_optimizer_state` and ``models.params.shard_state_dict``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from scd_tpu_torch.core import multihost
from scd_tpu_torch.models.params import gather_tensor, shard_tensor


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Per-step checkpoints with retention and best-metric tracking."""

    def __init__(self, directory: str, keep: int = 3,
                 best_metric: Optional[str] = None, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = directory
        self.keep = keep
        self.best_metric = best_metric
        self.mode = mode
        self._writer = multihost.process_index() == 0
        if self._writer:
            os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)
        else:
            self._manifest = {"steps": [], "best_step": None,
                              "best_value": None}

    # ------------------------------------------------------------ paths
    def _blob(self, step) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _meta(self, step) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.json")

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any,
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Write checkpoint ``step``; update best; prune old non-best.
        Over several ranks rank 0 writes and every rank waits for it."""
        path = self._blob(step)
        if self._writer:
            torch.save(_to_host(state), path + ".tmp")
            os.replace(path + ".tmp", path)  # atomic: no torn blob
            with open(self._meta(step), "w") as f:
                json.dump({"step": step, "metrics": metrics or {}}, f)

        if step not in self._manifest["steps"]:
            self._manifest["steps"].append(step)
        if (self.best_metric and metrics
                and self.best_metric in metrics):
            v = float(metrics[self.best_metric])
            best = self._manifest["best_value"]
            improved = (best is None
                        or (v > best if self.mode == "max" else v < best))
            if improved:
                self._manifest["best_step"] = step
                self._manifest["best_value"] = v
                if self._writer:
                    shutil.copyfile(path, os.path.join(self.directory,
                                                       "ckpt_best.pt"))
                    with open(os.path.join(self.directory,
                                           "ckpt_best.json"), "w") as f:
                        json.dump({"step": step, "metrics": metrics}, f)
        self._prune()
        if self._writer:
            with open(self._manifest_path, "w") as f:
                json.dump(self._manifest, f)
        if multihost.is_multiprocess():
            multihost.barrier()
        return path

    def _prune(self):
        steps = sorted(self._manifest["steps"])
        excess = steps[:-self.keep] if self.keep else []
        for s in excess:
            for p in (self._blob(s), self._meta(s)):
                if self._writer and os.path.exists(p):
                    os.remove(p)
            self._manifest["steps"].remove(s)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        return max(self._manifest["steps"]) if self._manifest["steps"] else None

    def restore(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, state) of checkpoint ``step``, default the latest; the
        state's tensors on the host.  (The JAX package restores into a
        target tree; a torch blob carries its own structure.)"""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step, torch.load(self._blob(step), map_location="cpu",
                                weights_only=True)

    def restore_best(self) -> Tuple[int, Any]:
        path = os.path.join(self.directory, "ckpt_best.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no best checkpoint in {self.directory}")
        return int(self._manifest["best_step"]), torch.load(
            path, map_location="cpu", weights_only=True)


def _param_names(opt: torch.optim.Optimizer, model) -> List[str]:
    """The name in ``model`` of each parameter of ``opt``, in the order
    of its state dict's indices."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


def _map_state(sd: Dict, names: List[str], fn) -> Dict:
    state = {i: {k: fn(names[i], v) if isinstance(v, torch.Tensor) else v
                 for k, v in sd["state"][i].items()}
             for i in sorted(sd["state"])}
    return {"state": state, "param_groups": sd["param_groups"]}


def gather_optimizer_state(opt: torch.optim.Optimizer, model, tp) -> Dict:
    """``opt.state_dict()`` with each per-parameter tensor (SGD's
    momentum) of a tensor-parallel parameter gathered whole over ``tp``'s
    group (``models.params.gather_tensor``; every rank of it calls);
    ``tp`` None returns the state dict as it is."""
    sd = opt.state_dict()
    if tp is None:
        return sd
    return _map_state(sd, _param_names(opt, model),
                      lambda name, t: gather_tensor(name, t, tp))


def shard_optimizer_state(state: Dict, opt: torch.optim.Optimizer, model,
                          tp) -> Dict:
    """The inverse of :func:`gather_optimizer_state`: a full optimizer
    state dict with this rank's shard of each per-parameter tensor, for
    ``opt.load_state_dict``."""
    if tp is None:
        return state
    return _map_state(state, _param_names(opt, model),
                      lambda name, t: shard_tensor(name, t, tp.size,
                                                   tp.index))


def strip_key_prefix(state_dict: Dict[str, Any],
                     prefix: str = "module.") -> Dict[str, Any]:
    """Drop a key prefix from a flat state dict (reference
    ``strip_state_dict``, ``general_utils.py:47-58``: DataParallel-saved
    checkpoints)."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}
