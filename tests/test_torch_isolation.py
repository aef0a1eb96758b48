"""The port imports neither JAX nor anything of the JAX package.

A fresh interpreter imports every ``scd_tpu_torch`` module (the towers,
the tokenizer, the kernels' ops, the runners, the serving entry point, the
ptsup entry point, the constrained and FINCH clusterers, the min-cost-flow
bridge, the reference-cache importer, the training subpackages ``train``
and ``utils`` (the runtime, log-parsing and plot modules too), the NCD
baselines, WTA hashing and the ResNet towers among them, the mesh
modules ``core.mesh``, ``core.multihost`` and ``testing.dist``, and the
scripts' counterparts ``scripts.scale_smoke`` and
``scripts.multihost_smoke``) and
``chip_smoke``, then looks at
``sys.modules``.  ``scd_tpu_torch`` itself
starts with ``scd_tpu``, so the check matches the JAX package by exact name
or the ``scd_tpu.`` prefix.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import scd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scd_tpu_torch.__path__,
                                              "scd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "scd_tpu" or m.startswith("scd_tpu."))
print(len(names), bad, ",".join(names))
"""


def test_port_imports_no_jax_and_no_scd_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    n_modules, bad, names = res.stdout.strip().split(" ", 2)
    # the towers, tokenizer, W8A8 and attention ops, runners, serving,
    # ptsup, interop, constrained + sinkhorn + native, finch, training,
    # the baselines, WTA hashing and the ResNet towers
    assert int(n_modules) >= 82
    assert bad == "[]", bad
    assert {f"scd_tpu_torch.train.{m}" for m in (
        "losses", "schedulers", "checkpoint", "gcd", "metric_learn",
        "baselines", "baselines_e2e", "run_baseline", "run_baseline_e2e")} | {
        "scd_tpu_torch.utils.experiment", "scd_tpu_torch.data.augment",
        "scd_tpu_torch.data.transforms", "scd_tpu_torch.ops.wta",
        "scd_tpu_torch.models.resnet", "scd_tpu_torch.models.resnet50",
        "scd_tpu_torch.utils.runtime", "scd_tpu_torch.utils.logparse",
        "scd_tpu_torch.utils.plots", "scd_tpu_torch.core.mesh",
        "scd_tpu_torch.core.multihost", "scd_tpu_torch.testing.dist",
        "scd_tpu_torch.scripts.scale_smoke",
        "scd_tpu_torch.scripts.multihost_smoke"} <= \
        set(names.split(","))


def test_spawned_ranks_import_no_jax():
    """A rank started by ``testing/dist.py`` (two gloo ranks, from this
    process, which has JAX loaded) holds neither JAX nor the JAX package
    after making a mesh and running a collective."""
    from scd_tpu_torch.testing.dist import spawn

    assert spawn("scd_tpu_torch.testing.mesh_cases.foreign_modules",
                 world=2, timeout=60) == [[], []]
