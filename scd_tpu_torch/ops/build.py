"""Build and load the hand-written CUDA kernels and the host C++ solver.

Each kernel is one ``scd_tpu_torch/csrc/<name>.cu`` file with a plain C
interface.  At first use it is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

A ``scd_tpu_torch/csrc/<name>.cc`` file (the min-cost-flow solver, which
runs on the host) takes the host route instead,

    g++ -O3 -std=c++17 -shared -fPIC -o lib<name>_<hash>.so <name>.cc

without ``-march=native``, whose code differs between hosts.  Both go
into the build directory (``SCD_TORCH_KERNEL_DIR``, default
``scd_tpu_torch/_build``, listed in ``.gitignore``) and loaded with
``ctypes``.  No PyTorch headers are involved, so a build takes seconds and
needs no ``ninja``.  Kernels that load through TMA take
``cuTensorMapEncodeTiled`` from libcuda through
``cudaGetDriverEntryPoint``, so no library links ``-lcuda``.  The library name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("SCD_TORCH_KERNEL_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "_build")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found; the host solver builds with it")
    return path


def _route(name: str):
    """(source, compiler, flags) of ``name``: ``<name>.cu`` for ``nvcc``,
    else ``<name>.cc`` for the host compiler."""
    cu = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(cu):
        return cu, nvcc, NVCC_FLAGS
    return os.path.join(CSRC, f"{name}.cc"), gxx, GXX_FLAGS


def library_path(name: str) -> str:
    src, _compiler, flags = _route(name)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(build_dir(), f"lib{name}_{tag.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one compiler
    per source, all started together.  Returns {name: compiler report
    (``nvcc``'s holds ptxas's)} for the sources compiled now; raises with
    the compiler's output when one fails."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        src, compiler, flags = _route(name)
        cmd = [compiler(), *flags, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic publish: a concurrent loader never sees a torn .so
        reports[name] = log
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library of ``name`` (a kernel, or the host solver), built on
    first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
