"""Run a function of the port in ``world`` ranks and collect their results.

    spawn("scd_tpu_torch.testing.mesh_cases.library_cases", world=2,
          backend="gloo", device="cpu", args=(...,), timeout=60)

starts ``world`` fresh interpreters (``python -m
scd_tpu_torch.testing.dist``: unlike a ``multiprocessing`` spawn, nothing
re-imports the caller's main module), brings up a process group in each
over a ``file://`` store in a temporary directory
(``core.multihost.initialize``), calls the function named by its dotted
path with ``args`` and returns every rank's (pickled) result in rank
order.  It kills every rank and raises when one fails (with its
traceback) or when the deadline passes, so a hung rank fails its caller
instead of hanging it.  The children import the named function's module
and what it imports: the port's tests and ``chip_smoke.py`` both run
functions of the port here, never a test module, never JAX.

On a card every rank binds ``cuda:(rank mod cards)``: ``backend="gloo"``
puts several ranks on one card, ``nccl`` takes one card per rank.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _child(rank: int, job_path: str) -> None:
    """One rank: initialize, run the function, write its result."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    result_path = os.path.join(job["dir"], f"rank{rank}.pkl")
    try:
        import torch

        if job["threads"]:
            torch.set_num_threads(job["threads"])
        from scd_tpu_torch.core import multihost

        multihost.initialize(
            init_method=f"file://{job['store']}", world_size=job["world"],
            rank=rank, local_rank=rank, backend=job["backend"],
            device=job["device"], timeout=job["collective_timeout"])
        module, _, name = job["fn"].rpartition(".")
        fn = getattr(importlib.import_module(module), name)
        out = ("ok", fn(*job["args"]))
        multihost.barrier()
        multihost.shutdown()
    except BaseException:  # the parent raises it with this traceback
        out = ("error", traceback.format_exc())
    with open(result_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(result_path + ".tmp", result_path)
    if out[0] == "error":
        sys.exit(1)


def spawn(fn_name: str, world: int, backend: str = "gloo",
          device: str = "cpu", args: Sequence[Any] = (),
          timeout: float = 60.0, collective_timeout: float = None,
          threads: int = 1) -> List[Any]:
    """Every rank's ``fn(*args)`` (see the module docstring).  ``timeout``
    (seconds) is the deadline for the whole world, start-up included;
    ``collective_timeout`` bounds each collective inside (default: the
    deadline).  ``threads``: torch's intra-op threads per rank (0 leaves
    torch's default)."""
    tmp = tempfile.mkdtemp(prefix="scd_dist_")
    procs = []
    try:
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump({"fn": fn_name, "args": tuple(args), "world": world,
                         "backend": backend, "device": device,
                         "store": os.path.join(tmp, "store"), "dir": tmp,
                         "collective_timeout": collective_timeout or timeout,
                         "threads": threads}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            env.pop(var, None)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "scd_tpu_torch.testing.dist", str(r),
             job_path], cwd=_ROOT, env=env) for r in range(world)]
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code " \
                         f"{procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"deadline of {timeout:.0f} s passed"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.returncode})")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        if failed or errors:
            raise RuntimeError(f"spawn({fn_name}, world={world}) failed: "
                               f"{failed or ''}\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    _child(int(sys.argv[1]), sys.argv[2])
