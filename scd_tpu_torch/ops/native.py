"""ctypes bridge to the exact min-cost-flow solver (host C++).

Port of ``scd_tpu/ops/native.py``.  The solver's source is the port's own
copy, ``scd_tpu_torch/csrc/mincostflow.cc`` (byte-equal to the JAX
package's ``native/mincostflow.cc``); ``ops/build.py`` compiles it with
the host compiler at first use into the port's build directory, under a
name hashed from the source and the flags.  Nothing here reads or writes
the JAX package's ``native/libscdmcf.so``.

- ``mcf_solve``: generic min-cost flow over an arc list;
- ``constrained_assign``: the size-constrained nearest-centroid E-step of
  ConSSKM (the reference's OR-Tools call path,
  ``sskm_constrained.py:331-356``), with the whole graph built natively.

The solver runs on the host whatever the features' device.  A ctypes call
releases the GIL for its whole duration, so restarts in threads overlap
their solves with each other's device work.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from scd_tpu_torch.ops import build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load("mincostflow")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.scd_mcf_solve.restype = ctypes.c_int
        lib.scd_mcf_solve.argtypes = [
            ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p, i32p, i32p,
            i64p, ctypes.c_int32]
        lib.scd_constrained_assign.restype = ctypes.c_int
        lib.scd_constrained_assign.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            ctypes.c_int32, i32p, ctypes.c_int32]
        _lib = lib
        return lib


def mcf_solve(tail: np.ndarray, head: np.ndarray, cap: np.ndarray,
              cost: np.ndarray, supply: np.ndarray,
              method: str = "cost_scaling") -> np.ndarray:
    """Solve min-cost flow; returns per-arc flow. Raises on infeasibility."""
    lib = _load()
    tail = np.ascontiguousarray(tail, np.int32)
    head = np.ascontiguousarray(head, np.int32)
    cap = np.ascontiguousarray(cap, np.int32)
    cost = np.ascontiguousarray(cost, np.int32)
    supply = np.ascontiguousarray(supply, np.int32)
    flow = np.zeros(len(tail), np.int64)
    rc = lib.scd_mcf_solve(len(supply), len(tail), tail, head, cap, cost,
                           supply, flow, 1 if method == "ssp" else 2)
    if rc != 0:
        raise RuntimeError(f"min-cost-flow solve failed (status {rc})")
    return flow


_ASSIGN_METHODS = {"auto": 0, "ssp": 1, "cost_scaling": 2, "sparse": 3}


def constrained_assign(costs: np.ndarray, size_min: int, size_max: int,
                       method: str = "auto") -> np.ndarray:
    """Labels minimizing total cost s.t. size_min <= |cluster| <= size_max.

    ``costs``: [n_x, n_c] int32 (pre-rounded; the ConSSKM caller rounds
    1000*sqrt(sqdist) like the reference, ``sskm_constrained.py:324``).

    ``method``: "auto" (default) solves large instances by exact sparse
    candidate-arc pricing and small ones densely; "cost_scaling"/"ssp"
    force the dense solvers; "sparse" forces the pricing path.
    """
    lib = _load()
    costs = np.ascontiguousarray(costs, np.int32)
    n_x, n_c = costs.shape
    labels = np.zeros(n_x, np.int32)
    rc = lib.scd_constrained_assign(n_x, n_c, costs, size_min, size_max,
                                    labels, _ASSIGN_METHODS.get(method, 0))
    if rc == 2:
        raise ValueError(
            f"infeasible size constraints: n_x={n_x}, n_c={n_c}, "
            f"size_min={size_min}, size_max={size_max}")
    if rc != 0:
        raise RuntimeError(f"constrained assignment failed (status {rc})")
    return labels
