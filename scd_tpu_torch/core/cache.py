"""Stage-artifact cache.

The same ``<stage>_<key>.npz`` + ``<stage>_<key>.json`` layout as the JAX
package (``scd_tpu/core/cache.py``), so each package reads the other's
caches: artifacts are ``.npz`` files named by a config hash, with a JSON
sidecar describing provenance (the reference's ``.pt`` cache protocol,
``main_unsup.py:294-311, 366-374``, with deterministic keys).

:func:`tensors_from_arrays` turns a numpy artifact dict into the port's
tensors with fixed dtype rules, so both packages compute on the same
inputs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class ArtifactCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _paths(self, stage: str, key: str):
        base = os.path.join(self.root, f"{stage}_{key}")
        return base + ".npz", base + ".json"

    def has(self, stage: str, key: str) -> bool:
        npz, _ = self._paths(stage, key)
        return os.path.exists(npz)

    def save(self, stage: str, key: str, arrays: Dict[str, np.ndarray],
             meta: Optional[dict] = None) -> str:
        npz, js = self._paths(stage, key)
        # unique tmp per writer: two processes saving the same stage/key
        # must not interleave into one tmp file
        tmp = f"{npz}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, npz)  # atomic publish so a crash never leaves a torn cache
        with open(js, "w") as f:
            json.dump({"stage": stage, "key": key, "time": time.time(),
                       "meta": meta or {},
                       "arrays": {k: list(np.asarray(v).shape) for k, v in arrays.items()}},
                      f, indent=2, default=str)
        return npz

    def load(self, stage: str, key: str) -> Dict[str, np.ndarray]:
        npz, _ = self._paths(stage, key)
        with np.load(npz, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def load_or_compute(self, stage: str, key: str, fn, meta: Optional[dict] = None,
                        refresh: bool = False) -> Dict[str, np.ndarray]:
        """The cached arrays, or ``fn()``'s, saved.  Over several ranks
        (``core.multihost``) every rank takes the same branch (a hit only
        when every rank sees the file: one ``all_reduce``), every rank
        computes on a miss (``fn`` may hold collectives), rank 0 alone
        writes and a ``barrier`` publishes the file before anyone reads
        on."""
        from scd_tpu_torch.core import multihost

        if not multihost.is_multiprocess():
            if not refresh and self.has(stage, key):
                return self.load(stage, key)
            arrays = fn()
            self.save(stage, key, arrays, meta=meta)
            return arrays
        hit = torch.tensor([int(not refresh and self.has(stage, key))])
        if int(multihost.all_reduce(hit, "min")):
            arrays = self.load(stage, key)
        else:
            arrays = fn()
            if multihost.process_index() == 0:
                self.save(stage, key, arrays, meta=meta)
        multihost.barrier()
        return arrays


# artifact keys whose dtype is fixed on the way in; every other float array
# becomes f32, every other integer array int64
_INT_KEYS = ("targets", "u_targets", "u_preds", "all_preds")
_BOOL_KEYS = ("mask_lab", "mask_cls", "mask")


def tensors_from_arrays(arrays: Dict[str, np.ndarray],
                        device) -> Dict[str, torch.Tensor]:
    """The JAX package's numpy artifact dicts as the port's tensors on
    ``device``: features and weights -> f32, ``targets`` (and the other
    label arrays) -> int64, masks -> bool.  The feature caches store
    ``targets`` as float64 (``extract_features``), so the integer cast is
    part of the contract, not a convenience."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if k in _BOOL_KEYS:
            t = torch.from_numpy(a.astype(bool))
        elif k in _INT_KEYS or np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        out[k] = t.to(device)
    return out
