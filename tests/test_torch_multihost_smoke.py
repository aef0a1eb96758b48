"""The port's multi-process smoke (``scd_tpu_torch/scripts/
multihost_smoke.py``) on the CPU: 2 processes x 1 rank of gloo, the
launcher's exit code (0 only when every rank printed the same digest),
and the stage smoke's k-means and SSKM against a single JAX process on
the same global data under ``tests/test_multihost.py``'s contract:
inertia within 1e-3 relative, ARI above 0.99 (the ranks' merged sums
reassociate, and the k-means++ draws differ: ``torch.Generator`` against
threefry).  ``--pipeline train`` (a GCD step at ``model`` 2, UNO and
AutoNovel end to end) exits 0 with agreeing digests."""

import os
import subprocess
import sys

import jax
import numpy as np
from sklearn.metrics import adjusted_rand_score

from scd_tpu.cluster import fit_kmeans, fit_sskm
from scd_tpu.core.config import ClusterConfig
from scd_tpu_torch.scripts.multihost_smoke import global_blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(*extra):
    proc = subprocess.run(
        [sys.executable, "-m", "scd_tpu_torch.scripts.multihost_smoke",
         "--launch", "2", "--devices_per_proc", "1", "--device", "cpu",
         "--timeout", "240", *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-500:]
    return proc.stdout


def test_stage_smoke_matches_a_single_jax_process(tmp_path):
    out = _launch("--dump_dir", str(tmp_path))
    fields = out.split("MULTIHOST ")[1].split()
    x, _y = global_blobs()
    res = fit_kmeans(jax.random.PRNGKey(0), x, ClusterConfig(
        n_clusters=5, n_init=4, max_iterations=25))
    np.testing.assert_allclose(float(fields[0]), res.inertia, rtol=1e-3)
    labels = np.load(tmp_path / "labels_0.npy")
    assert labels.shape == res.labels.shape
    assert adjusted_rand_score(res.labels, labels) > 0.99

    xl, yl = global_blobs(n_global=80, seed=3)
    res_sskm = fit_sskm(jax.random.PRNGKey(4), x, xl, yl, ClusterConfig(
        n_clusters=5, n_init=2, max_iterations=15))
    np.testing.assert_allclose(float(fields[fields.index("sskm") + 1]),
                               res_sskm.inertia, rtol=1e-3)
    sskm = np.load(tmp_path / "labels_sskm_0.npy")
    assert sskm.shape == res_sskm.labels.shape
    assert adjusted_rand_score(res_sskm.labels, sskm) > 0.99
    # every rank dumped the same labels
    np.testing.assert_array_equal(labels, np.load(tmp_path / "labels_1.npy"))


def test_train_pipeline_ranks_agree():
    out = _launch("--pipeline", "train")
    assert "multihost smoke ok: 2 processes x 1 ranks" in out
    assert out.count("TRAIN gcd ") == 3  # each rank's line, the launcher's
