"""Runtime helpers of the port: stage timing and profiling.

Port of ``scd_tpu/utils/runtime.py``.  :func:`block_timed` times a stage on
the host clock; while a CUDA device is in use it brackets the stage with
``torch.cuda.synchronize`` so that work queued before the stage is not
counted and work queued inside it is.  :func:`profile_trace` records the
stage with ``torch.profiler`` (CPU and, with a card, CUDA activities) and
writes a Chrome trace into ``out_dir``.

Not ported, as they are JAX-only: ``apply_platform_override`` (it honours
``SCD_PLATFORM`` through ``jax.config``; the port's entry points take
``--device`` instead) and ``enable_compilation_cache`` (XLA's persistent
compilation cache; PyTorch runs eagerly, and ``ops/build.py`` keeps the
CUDA kernels' builds).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _sync() -> None:
    """Wait for the current CUDA device's queued work, when a card is in
    use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def block_timed(label: str, results: Optional[dict] = None
                ) -> Iterator[None]:
    """Wall-time a stage to the end of its work on the current CUDA
    device; prints ``[timing] {label}: {seconds:.3f}s`` and stores the
    seconds in ``results[label]`` when given."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    print(f"[timing] {label}: {dt:.3f}s")


@contextlib.contextmanager
def profile_trace(out_dir: str) -> Iterator[None]:
    """``torch.profiler`` around a stage; writes ``out_dir/trace.json``
    (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
