"""The port's host utilities (``scd_tpu_torch/utils/{runtime,logparse,
plots}.py``) on the CPU.

- ``parse_run_log`` / ``summarize_runs`` against the JAX package's on the
  same logs: the logs of ``tests/test_utils_misc.py`` and
  ``tests/test_reference_parity.py``, and one the port's synthetic
  ``run_unsup`` prints; the dicts must be equal.
- ``block_timed`` prints its line and stores the seconds;
  ``profile_trace`` writes a Chrome trace that holds the traced op.
- The three figure savers write non-empty PNGs.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from scd_tpu.utils import logparse as jlog
from scd_tpu_torch.utils import logparse as tlog

LOGS = {
    "misc": (
        "Namespace(dataset_name='cub', lr=0.1, n_cluster=100, te=False)\n"
        "SSKM Accuracies: All 0.977 | Old 0.955 | New 1.0\n"
        "iter: 1\n"
        "Accuracies: All 0.98 | Old 0.96 | New 1.0\n"
        "ACC/sACC_avg/sACC_all: All 98.0/54.0/52.0 \n"
        "ACC/Soft sACC: All 98.0/77.5\n"
        "Epoch 0: loss 1.5000 | acc 0.6000\n"
        "Epoch 1: loss 1.2000 | acc 0.7000\n"
        "IoU: 0.41\n"),
    "slurm": (
        "Namespace(batch_size=128, dataset_name='cub', lr=0.1, "
        "model_dir='/work/log/(10.01.2022_|_35.570)/checkpoints', "
        "rand_aug_m=30, rand_aug_n=2, weight_decay=5e-05)\n"
        "Train Epoch: 0 Avg Loss: 4.1\n"
        "Train Accuracies: All 0.4012 | Old 0.5211 | New 0.3310\n"
        "Train Epoch: 1 Avg Loss: 3.2\n"
        "Train Accuracies: All 0.6123 | Old 0.7001 | New 0.5432\n"
        "Best Train Accuracies: All 0.6123 | Old 0.7001 | New 0.5432\n"),
    "empty": "no metric line here\n",
}


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The fixed logs and the port's synthetic ``run_unsup`` log."""
    from scd_tpu_torch.pipelines.unsup import main

    root = tmp_path_factory.mktemp("logs")
    paths = []
    for name, text in LOGS.items():
        p = root / f"{name}.log"
        p.write_text(text)
        paths.append(str(p))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--dataset_name", "synthetic", "--cache_dir",
              str(root / "cache"), "--device", "cpu"])
    p = root / "synthetic_run_unsup.log"
    p.write_text(buf.getvalue())
    paths.append(str(p))
    return paths


def test_parse_run_log_equals_jax(logs):
    for path in logs:
        got, want = tlog.parse_run_log(path), jlog.parse_run_log(path)
        assert got == want, path
        with open(path) as f:
            lines = f.readlines()
        assert tlog.parse_run_log(lines) == want  # the list-of-lines form
    synthetic = tlog.parse_run_log(logs[-1])
    assert synthetic["iou"] == 1.0 and synthetic["sacc"]
    assert synthetic["accs"] and synthetic["soft_sacc"]
    misc = tlog.parse_run_log(logs[0])
    assert misc["epochs"][1] == {"epoch": 1, "loss": 1.2, "acc": 0.7}
    assert [a["tag"] for a in misc["accs"]] == ["SSKM", ""]


def test_summarize_runs_equals_jax(logs):
    got, want = tlog.summarize_runs(logs), jlog.summarize_runs(logs)
    assert got == want and len(got) == len(logs)
    assert got[0]["all"] == 0.98 and got[0]["iou"] == 0.41


def test_block_timed_prints_and_stores(capsys):
    from scd_tpu_torch.utils import block_timed

    results = {}
    with block_timed("stage", results):
        torch.ones(8, 8).sum()
    assert results["stage"] >= 0.0
    out = capsys.readouterr().out
    assert out == f"[timing] stage: {results['stage']:.3f}s\n"


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from scd_tpu_torch.utils.runtime import profile_trace

    out = tmp_path / "trace"
    with profile_trace(str(out)):
        torch.ones(16, 16) @ torch.ones(16, 16)
    with open(out / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_plot_savers_write_pngs(tmp_path):
    from scd_tpu_torch.utils.plots import (save_cvi_curves, save_heatmap,
                                           save_tsne)

    rng = np.random.default_rng(0)
    paths = [str(tmp_path / n) for n in ("tsne.png", "heat.png", "cvi.png")]
    save_tsne(rng.standard_normal((60, 8)).astype(np.float32),
              rng.integers(0, 3, 60), path=paths[0])
    save_heatmap(rng.random((6, 4)), path=paths[1])
    save_cvi_curves([[0.5, 0.4, 0.3], [0.6, 0.5, 0.4]], k_list=[5, 10],
                    path=paths[2])
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(p) > 100
