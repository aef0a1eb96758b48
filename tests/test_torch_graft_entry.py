"""``scd_tpu_torch.graft_entry``: the one-device forward and the
multi-rank dry run (the counterpart of ``__graft_entry__.py``).

- ``dryrun_multichip(4, device="cpu")`` in a fresh interpreter (it starts
  its own ranks): a mesh of ``data`` 2 x ``model`` 2, every rank ending
  on the same ``dryrun_multichip ok`` line;
- ``entry(device="cpu")``: a finite [4, 512] f32 from the CLIP ViT-B/16
  image encoder at bf16, equal to ``CLIPModel.encode_image`` on the same
  parameters, on other images too;
- on the card (``gpu`` marker): ``entry()`` runs the attention kernel and
  agrees with the CPU forward to BF16_COS a row.

JAX-free, so the card's machine runs it with ``--noconftest``.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card's bf16 tower against the CPU's: bf16 rounding in another order
# of sums (the tensor-core tiles, the attention kernel), row by row
BF16_COS = 0.9998  # chip_smoke.TOWER_COS_TOL, its towers' bound


def _images(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((4, 224, 224, 3), generator=g)


def test_dryrun_multichip_runs_in_a_clean_subprocess():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    out = subprocess.run(
        [sys.executable, "-c", "from scd_tpu_torch.graft_entry import "
         "dryrun_multichip; dryrun_multichip(4, device='cpu')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun_multichip ok: mesh={'data': 2, "
                           "'model': 2}, train loss="), last
    assert "UNO e2e dp+tp loss=" in last


def test_entry_on_cpu_equals_encode_image():
    from scd_tpu_torch.graft_entry import entry
    from scd_tpu_torch.models.clip import CLIPModel

    fn, (model, images) = entry(device="cpu")
    assert isinstance(model, CLIPModel)
    out = fn(model, images)
    assert tuple(out.shape) == (4, 512) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    with torch.no_grad():
        assert torch.equal(out, model.encode_image(images))
        x = _images(0)
        assert torch.equal(fn(model, x), model.encode_image(x))


@pytest.mark.gpu
def test_entry_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from scd_tpu_torch.core.device import f32_matmuls
    from scd_tpu_torch.graft_entry import entry
    from scd_tpu_torch.ops import attention

    f32_matmuls()
    fn, (model, images) = entry()
    before = attention.attention_cuda.launches
    out = fn(model, images)
    assert attention.attention_cuda.launches > before
    assert tuple(out.shape) == (4, 512) and out.dtype == torch.float32
    assert out.is_cuda and torch.isfinite(out).all()
    x = _images(1)
    got = fn(model, x.cuda()).cpu()
    want = fn(model.cpu(), x)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min() >= BF16_COS, cos
