"""The port's shell wrappers (``scd_tpu_torch/scripts/*.sh``) against the
JAX package's (``scripts/*.sh``), on the CPU.

- Each of the 13 wrappers other than ``hw_evidence.sh`` runs twice under
  one environment, once as the JAX script and once as the port's, with a
  stub ``python`` first on ``PATH`` that records its argv instead of
  running anything.  The recorded calls must be equal after
  ``scd_tpu.`` -> ``scd_tpu_torch.`` in the JAX ones and with the
  ``--device X`` pairs the port's wrapper adds taken out of the port's;
  the temporary directory ``smoke_all.sh`` makes reads as one name.
- ``smoke_all.sh``'s counterpart runs for real at ``DEVICE=cpu``: every
  CLI of the port on the synthetic dataset; it exits 0 and prints
  ``ALL CLIS OK``.
"""

import os
import re
import stat
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = ("acc_at_k_sweep.sh", "autonovel_gcd.sh", "estimate_k.sh",
            "evaluate_partial_supervised.sh", "evaluate_unsupervised.sh",
            "extract_features.sh", "k_means.sh", "k_means_stratified.sh",
            "k_means_with_classifier_init.sh", "metric_learn.sh",
            "smoke_all.sh", "train_supervised_classifier.sh",
            "uno_v2_gcd.sh")
# what the wrappers read from the environment (the required ones set)
ENV = {"FEATURES": "feats/features_packed.npz", "N_TRAIN_CLASSES": "5",
       "N_LABELED": "7", "DATASET": "cub", "SSB_DIR": "ssb",
       "K_LIST": "10 30", "ROOT_DIR": "root", "EPOCHS": "3"}
SEP = "\x1f"


def _recorded(script, tmp_path, tag):
    """The argv of every ``python`` call ``script`` makes (with ``--x 1``
    after its own arguments), each call a list of strings."""
    bindir = tmp_path / f"bin-{tag}"
    bindir.mkdir()
    log = tmp_path / f"argv-{tag}"
    stub = bindir / "python"
    stub.write_text("#!/bin/sh\nfor a in \"$@\"; do printf '%s\\037' \"$a\"; "
                    "done >> \"$ARGV_LOG\"\necho >> \"$ARGV_LOG\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    tmpdir = tmp_path / f"tmp-{tag}"
    tmpdir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "SCD_PLATFORM")}
    env.update(ENV, PATH=f"{bindir}{os.pathsep}{env['PATH']}",
               ARGV_LOG=str(log), TMPDIR=str(tmpdir))
    res = subprocess.run(["bash", script, "--x", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    calls = [ln.split(SEP)[:-1] for ln in log.read_text().splitlines()]
    # smoke_all's `mktemp -d`
    tmp = re.compile(re.escape(str(tmpdir)) + r"/tmp\.\w+")
    return [[tmp.sub("$TMP", a) for a in c] for c in calls]


def _without_device(call):
    out, it = [], iter(call)
    for a in it:
        if a == "--device":
            next(it)
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_argv_matches_the_jax_wrapper(tmp_path, name):
    want = _recorded(os.path.join(ROOT, "scripts", name), tmp_path, "jax")
    got = _recorded(os.path.join(ROOT, "scd_tpu_torch", "scripts", name),
                    tmp_path, "torch")
    assert want, f"{name} made no python call"
    assert [_without_device(c) for c in got] == [
        [a.replace("scd_tpu.", "scd_tpu_torch.") for a in c] for c in want]
    if name == "smoke_all.sh":  # every CLI on the smoke's device
        assert all(c[c.index("--device") + 1] == "cpu" for c in got)


def test_console_scripts_name_the_ports_mains():
    """``pyproject.toml``'s ``scd-torch-*`` entries: one beside each JAX
    ``scd-*`` entry, each naming a ``main`` of the port."""
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ported = {k: v for k, v in scripts.items() if k.startswith("scd-torch-")}
    assert {k.replace("scd-torch-", "scd-") for k in ported} == \
        set(scripts) - set(ported)
    for name, target in ported.items():
        module, _, fn = target.partition(":")
        assert target == scripts[name.replace("scd-torch-", "scd-")].replace(
            "scd_tpu.", "scd_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), fn))


def test_hw_evidence_names_its_outputs_in_gitignore():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert {"GPU_SUITE_r*.txt", "CHIP_SMOKE_r*.txt"} <= set(ignored)


def test_smoke_all_runs_every_cli_on_the_cpu(tmp_path):
    # ten interpreters import the same modules: their bytecode is cached
    # under tmp_path after the first (the CLIs run as they are)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "PYTHONDONTWRITEBYTECODE")}
    env.update(DEVICE="cpu", TMPDIR=str(tmp_path),
               PYTHONPYCACHEPREFIX=str(tmp_path / "pycache"),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "scd_tpu_torch", "scripts",
                              "smoke_all.sh")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.rstrip().endswith("ALL CLIS OK")
