"""``estimate_k`` restarts from initial centers drawn on the CPU.

The k-means++ draws of a ``torch.Generator`` differ between the CPU and a
card, so the dynamic-K fit is held card against CPU from centers drawn
once on the CPU and copied to the device the fit runs on::

    with centers_drawn_on_cpu(x) as reset:
        for dev in ("cuda", "cpu"):
            reset()
            obj = estimate_k.labelled_acc_objective_dynamic(..., device=dev)
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def centers_drawn_on_cpu(x):
    """Within the block, every restart of
    ``scd_tpu_torch.cluster.estimate_k`` starts from ``_kpp_masked``'s
    centers drawn on the CPU from ``x`` (L2-normalised as the objective
    normalises it) and copied to the device of the rows it clusters.  The
    i-th draw since the block began, or since the last call of the yielded
    ``reset``, takes ``torch.Generator().manual_seed(i)``: two runs, each
    after a ``reset()``, start from the same centers on any device."""
    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    x_cpu = ek._normalized_device(x, "cpu")
    real, n_drawn = ek._kpp_masked, [0]

    def kpp(xs, k_active, max_k, generator):
        gen = torch.Generator().manual_seed(n_drawn[0])
        n_drawn[0] += 1
        return real(x_cpu, k_active, max_k, gen).to(xs.device)

    def reset():
        n_drawn[0] = 0

    ek._kpp_masked = kpp
    try:
        yield reset
    finally:
        ek._kpp_masked = real
