"""The port's augmentations (``scd_tpu_torch.data.augment``) and train /
eval transforms (``data.transforms.get_transform``) against the JAX
package's on the CPU: from one seed, on PIL images and arrays made from a
seed, both give bit-equal arrays (the same generator draws in the same
order through the same PIL and numpy operations).

Each transform is called several times on one thread, so the comparison
covers a run of draws of one per-thread generator; a second thread gets
its own generator in both packages (``ThreadRng``).
"""

import threading

import numpy as np
import pytest
from PIL import Image

from scd_tpu.data import augment as jaug
from scd_tpu.data import transforms as jtf
from scd_tpu_torch.data import augment as taug
from scd_tpu_torch.data import transforms as ttf


def _images():
    rng = np.random.default_rng(7)
    arr = (rng.random((45, 61, 3)) * 255).astype(np.uint8)
    gray = (rng.random((40, 40)) * 255).astype(np.uint8)
    return {"uint8": arr, "pil": Image.fromarray(arr),
            "float": rng.random((36, 36, 3)).astype(np.float32),
            "gray-pil": Image.fromarray(gray)}


FAMILIES = [("imagenet", None), ("cifar", None), ("cutout", None),
            ("herbarium", None), ("imagenet", (2, 9))]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,rand_aug", FAMILIES,
                         ids=["imagenet", "cifar", "cutout", "herbarium",
                              "rand_aug"])
def test_get_transform_bit_equal(name, rand_aug, train):
    kw = dict(image_size=32, train=train, seed=5, rand_aug=rand_aug)
    jfn, tfn = jtf.get_transform(name, **kw), ttf.get_transform(name, **kw)
    for tag, img in _images().items():
        for i in range(4):
            want, got = jfn(img), tfn(img)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), f"{tag} call {i}"


def test_uint8_array_at_the_resize_size_needs_no_pil(monkeypatch):
    """The imagenet family on a uint8 array already at image_size /
    crop_pct resizes nothing, so PIL is never reached."""
    img = (np.random.default_rng(1).random((36, 36, 3)) * 255).astype(
        np.uint8)  # int(32 / 0.875) = 36
    want = [jtf.get_transform("imagenet", 32, train=t, seed=2)(img)
            for t in (True, False)]

    def no_pil(*_a, **_k):
        raise AssertionError("PIL reached")

    monkeypatch.setattr(Image, "fromarray", no_pil)
    got = [ttf.get_transform("imagenet", 32, train=t, seed=2)(img)
           for t in (True, False)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_rand_augment_bit_equal_every_op():
    img = _images()["pil"]
    for i, (jop, tw) in enumerate(zip(jaug.AUGMENT_LIST, taug.AUGMENT_LIST)):
        assert jop[1:] == tw[1:]
        for m in (0, 9, 30):
            ja = jaug.RandAugment(1, m, seed=i, augment_list=[jop])
            ta = taug.RandAugment(1, m, seed=i, augment_list=[tw])
            for _ in range(3):
                assert np.array_equal(np.asarray(ta(img)),
                                      np.asarray(ja(img))), (jop[0].__name__,
                                                             m)
    ja, ta = jaug.RandAugment(3, 12, seed=4), taug.RandAugment(3, 12, seed=4)
    for _ in range(6):
        assert np.array_equal(np.asarray(ta(img)), np.asarray(ja(img)))


@pytest.mark.parametrize("inside", [False, True])
def test_cutout_bit_equal(inside):
    x = np.random.default_rng(3).random((20, 24, 3)).astype(np.float32)
    kw = dict(mask_size=7, p=0.7, cutout_inside=inside, seed=9)
    jc, tc = jaug.cutout(**kw), taug.cutout(**kw)
    for _ in range(8):
        assert np.array_equal(tc(x), jc(x))


def test_contrastive_views_and_thread_rng():
    img = _images()["uint8"]
    base = dict(image_size=32, train=True, seed=11)
    jv = jaug.ContrastiveViewGenerator(jtf.get_transform("imagenet", **base),
                                       n_views=3)
    tv = taug.ContrastiveViewGenerator(ttf.get_transform("imagenet", **base),
                                       n_views=3)
    for _ in range(2):
        got, want = tv(img), jv(img)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    # a second thread: the second generator of each ThreadRng, (seed, 1)
    out = {}

    def run():
        out["t"], out["j"] = tv(img), jv(img)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    for g, w in zip(out["t"], out["j"]):
        assert np.array_equal(g, w)
    r1 = taug.ThreadRng(3).get().random(4)
    assert np.array_equal(r1, jaug.ThreadRng(3).get().random(4))
