"""The port's scale smoke (``scd_tpu_torch/scripts/scale_smoke.py``) at its
``--small`` shapes on the CPU, against ``tests/test_scale_smoke.py``'s
thresholds and the JAX ``scripts/scale_smoke.py`` on the same fabricated
data: the top-k hit rate and the sACC bounds (no random draw) within
1e-6; the SSKM ACC and the voting loop's sACC within 0.01 (the k-means++
seeds differ: ``torch.Generator`` against threefry, a decision on record
in ROADMAP.md)."""

import os
import sys

import pytest

from scd_tpu_torch.scripts import scale_smoke


@pytest.fixture(scope="module")
def both():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import scale_smoke as jax_scale_smoke

    return (scale_smoke.main(["--small", "--device", "cpu"]),
            jax_scale_smoke.main(["--small"]))


def test_scale_smoke_small_meets_the_jax_thresholds(both):
    results, _ = both
    assert results["sskm_acc"][0] > 0.9
    lo, hi = results["consskm_sizes"]
    assert lo >= 30 and hi <= 2000
    assert results["topk_hit"] > 0.9
    assert results["voting_sacc"] > 0.9
    assert results["ub"] >= results["lb"] - 1e-9
    assert set(results) == set(both[1])


def test_scale_smoke_small_matches_jax(both):
    got, want = both
    for key in ("lb", "ub", "topk_hit"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)
    assert got["sskm_acc"][0] == pytest.approx(want["sskm_acc"][0], abs=0.01)
    assert got["voting_sacc"] == pytest.approx(want["voting_sacc"],
                                               abs=0.01)
