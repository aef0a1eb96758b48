"""The port's serving entry point against the JAX package's, on the CPU.

- A tiny CLIP (width 64, depth 2, 32 px) from one Flax tree: the same
  names and probabilities within 1e-4 through each package's
  ``build_clip_encoder`` + ``NameClassifier`` (f32 towers, sums in another
  order), and through ``classifier_from_run``.
- ``iter_image_batches`` on ``.npy`` / ``.npz`` with a ragged tail: equal
  batches and valid counts.
- The synthetic CLI prints the JAX package's lines and returns the same
  value; the real-asset CLI (``main``) returns the same image count and
  prints one line per image, on the same fabricated images and weights.
- The head's device is the one the caller names (``cuda`` by default,
  which raises without a card), not an attribute of the encoder.
"""

import contextlib
import io

import numpy as np
import pytest

PROB_TOL = 1e-4


def _tiny(vit_mod, clip_mod):
    return clip_mod.CLIPConfig(
        vision=vit_mod.ViTConfig(
            image_size=32, patch_size=8, width=64, depth=2, heads=2,
            quick_gelu=True, pre_post_norm=True, output_proj=32,
            patch_bias=False, norm_eps=1e-5),
        vocab_size=100, context_length=16, text_width=64, text_depth=2,
        text_heads=2, embed_dim=32)


@pytest.fixture(scope="module")
def tiny():
    from scd_tpu.models import clip as jclip
    from scd_tpu.models import vit as jvit
    from scd_tpu_torch.models import clip as tclip
    from scd_tpu_torch.models import vit as tvit
    from scd_tpu_torch.testing.fabricate import clip_state_dict

    tcfg, jcfg = _tiny(tvit, tclip), _tiny(jvit, jclip)
    sd = {k: v.numpy() for k, v in clip_state_dict(tcfg, seed=4).items()}
    tree = jclip.load_openai_clip_weights(sd, jcfg)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    nouns = [f"noun_{i}" for i in range(12)]
    zw = rng.standard_normal((32, 12)).astype(np.float32)
    zw /= np.linalg.norm(zw, axis=0, keepdims=True)
    return {"tcfg": tcfg, "jcfg": jcfg, "tree": tree, "images": images,
            "nouns": nouns, "zw": zw}


def test_name_classifier_matches_jax(tiny):
    from scd_tpu.pipelines import infer as J
    from scd_tpu_torch.pipelines import infer as T

    jenc = J.build_clip_encoder(tiny["tree"], tiny["jcfg"])
    tenc = T.build_clip_encoder(tiny["tree"], tiny["tcfg"], device="cpu")
    # the port's head takes its device explicitly; the JAX one has none
    for make in (
            lambda m, enc, **kw: m.NameClassifier(enc, tiny["zw"],
                                                  tiny["nouns"], **kw),
            lambda m, enc, **kw: m.classifier_from_run(
                enc, tiny["zw"], tiny["nouns"],
                ["noun_7", "noun_2", "noun_9", "noun_0"], **kw)):
        jnames, jprobs = make(J, jenc).classify(tiny["images"], topk=3)
        tnames, tprobs = make(T, tenc, device="cpu").classify(
            tiny["images"], topk=3)
        assert tnames == jnames
        np.testing.assert_allclose(tprobs, np.asarray(jprobs), atol=PROB_TOL,
                                   rtol=0)
    with pytest.raises(KeyError):
        T.classifier_from_run(tenc, tiny["zw"], tiny["nouns"], ["nope"],
                              device="cpu")


def test_name_classifier_head_device_is_explicit(monkeypatch):
    """The head runs on the device it is given, whatever the encoder: a
    bound method exposes no ``device`` of its instance.  The default is
    ``cuda``, which raises without a card instead of falling back."""
    import torch

    from scd_tpu_torch.pipelines import infer as T

    class Encoder:
        device = torch.device("cpu")

        def encode(self, images):
            return torch.ones(len(images), 4)

    enc = Encoder().encode
    assert not hasattr(enc, "device")
    zw = np.eye(4, 3, dtype=np.float32)
    names = ["a", "b", "c"]
    clf = T.NameClassifier(enc, zw, names, device="cpu")
    assert clf.device == torch.device("cpu") and clf._w.device == clf.device
    named, probs = clf.classify(np.zeros((2, 8, 8, 3), np.uint8), topk=2)
    assert len(named) == 2 and probs.shape == (2, 2)
    run = T.classifier_from_run(enc, zw, names, ["c", "a"], device="cpu")
    assert run._w.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        T.NameClassifier(enc, zw, names)
    with pytest.raises(RuntimeError, match="is_available"):
        T.classifier_from_run(enc, zw, names, ["a"])


@pytest.mark.parametrize("suffix", [".npy", ".npz"])
def test_iter_image_batches_ragged_tail(tmp_path, suffix):
    from scd_tpu.pipelines import infer as J
    from scd_tpu_torch.pipelines import infer as T

    images = np.random.default_rng(0).integers(0, 256, (11, 8, 8, 3)).astype(
        np.uint8)
    path = str(tmp_path / f"batch{suffix}")
    if suffix == ".npy":
        np.save(path, images)
    else:
        np.savez(path, images)  # stored under arr_0
    got = list(T.iter_image_batches(path, 4))
    want = list(J.iter_image_batches(path, 4))
    assert [n for _, n in got] == [n for _, n in want] == [4, 4, 3]
    for (g, _), (w, _) in zip(got, want):
        assert g.shape == (4, 8, 8, 3)
        np.testing.assert_array_equal(g, w)
    assert not got[-1][0][3:].any()  # the tail is zero-padded


def test_synthetic_cli_prints_jax_lines():
    from scd_tpu.pipelines.infer import main as jax_main
    from scd_tpu_torch.pipelines.infer import main as torch_main

    out = []
    for fn, argv in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            acc = fn(["--topk", "3"] + argv)
        out.append((acc, buf.getvalue().splitlines()))
    assert out[1] == out[0] and len(out[0][1]) == 5
    assert type(out[1][0]) is type(out[0][0])
    assert out[0][1][-1] == "top-3 accuracy on 16 synthetic test images: 1.0"


def test_main_returns_the_image_count_as_jax(tiny, tmp_path, monkeypatch):
    """Both packages' ``main`` on the same tiny CLIP checkpoint, names and
    five images in batches of two: each returns the count, 5, as an int,
    and prints one line per image."""
    import dataclasses

    import torch

    import scd_tpu.models as jmodels
    import scd_tpu_torch.models as tmodels
    from scd_tpu.pipelines.infer import main as jax_main
    from scd_tpu_torch.pipelines.infer import main as torch_main
    from scd_tpu_torch.testing.fabricate import clip_state_dict

    for mod, cfg in ((jmodels, tiny["jcfg"]), (tmodels, tiny["tcfg"])):
        def small(compute_dtype=None, dense_int8=False, cfg=cfg):
            return dataclasses.replace(
                cfg, compute_dtype=compute_dtype,
                vision=dataclasses.replace(cfg.vision,
                                           compute_dtype=compute_dtype))
        monkeypatch.setattr(mod, "clip_vit_b16_config", small)
    ckpt, zw, names, imgs = (str(tmp_path / f) for f in
                             ("clip.pt", "zw.npy", "names.txt", "imgs.npy"))
    torch.save(clip_state_dict(tiny["tcfg"], seed=4), ckpt)
    np.save(zw, tiny["zw"])
    with open(names, "w") as f:
        f.write("\n".join(tiny["nouns"]) + "\n")
    np.save(imgs, np.random.default_rng(3).integers(
        0, 256, (5, 32, 32, 3)).astype(np.uint8))
    argv = ["--dataset_name", "real", "--clip_weights", ckpt,
            "--zeroshot_weights", zw, "--names", names, "--images", imgs,
            "--batch_size", "2", "--topk", "2", "--num_workers", "1"]
    out = []
    for fn, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            count = fn(argv + extra)
        out.append((count, len(buf.getvalue().splitlines())))
    assert out[1] == out[0] == (5, 5)
    assert isinstance(out[1][0], int)


def test_mesh_request_raises():
    """``--mesh_data 2`` in a process launched alone (no ``torchrun``)
    asks for more ranks than the world has: it raises instead of serving
    on one device (``tests/test_torch_mesh_pipeline.py`` serves over 2)."""
    from scd_tpu_torch.pipelines.infer import main

    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        main(["--mesh_data", "2", "--device", "cpu"])
