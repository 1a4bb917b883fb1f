"""The port's copies of the image datasets against the JAX package's, on the
CPU, over a folder of PNG and JPEG files that the tests write.

``ClassImage``, ``ImageNet``, ``INaturalist`` and ``SRImage`` (train and
validation) yield the same arrays as the JAX classes for one seed of the
``random`` module (their crops and flips draw from it); LSUN needs the
``lmdb`` package, which both refuse to run without; ``ClassImage``'s
whole-batch ``get_batch`` and the native decode path
(``data.native``: ``decode_image``, ``decode_dims``,
``decode_pipeline_batch``) equal JAX's where the library builds with its
decoders.
"""
import random

import numpy as np
import pytest
from PIL import Image

from enhancing_tpu.data import classimage as jax_classimage
from enhancing_tpu.data import imagenet as jax_imagenet
from enhancing_tpu.data import inatural as jax_inatural
from enhancing_tpu.data import lsun as jax_lsun
from enhancing_tpu.data import native as jax_native
from enhancing_tpu.data import srimage as jax_srimage
from enhancing_tpu.data import transforms as jax_transforms
from enhancing_tpu_torch.data import (classimage, imagenet, inatural, lsun,
                                      native, srimage, transforms)

SIZES = [(20, 28), (24, 18), (17, 17), (30, 22)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """root/{train,val}/<class>/<image>: two classes, PNG and JPEG files of
    several sizes."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c, cls in enumerate(("n01", "n02")):
            d = root / split / cls
            d.mkdir(parents=True)
            for i, (h, w) in enumerate(SIZES):
                img = Image.fromarray(
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
                img.save(d / f"img{c}{i}.{'png' if i % 2 else 'jpg'}")
    return root


PAIRS = [
    ("ClassImageTrain", classimage, jax_classimage, {}),
    ("ClassImageValidation", classimage, jax_classimage, {}),
    ("ImageNetTrain", imagenet, jax_imagenet, {}),
    ("ImageNetValidation", imagenet, jax_imagenet, {}),
    ("INaturalistTrain", inatural, jax_inatural, {}),
    ("INaturalistValidation", inatural, jax_inatural, {}),
    ("SRImageTrain", srimage, jax_srimage, {"downscale": 4}),
    ("SRImageValidation", srimage, jax_srimage, {"downscale": 4}),
]


def _samples(ds):
    out = []
    for i in range(len(ds)):
        random.seed(100 + i)
        out.append(ds[i])
    return out


@pytest.mark.parametrize("name,port,ref,kw", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_dataset_yields_jax_arrays(folder, name, port, ref, kw):
    root = folder / "val" if name.startswith("SRImage") else folder
    got = getattr(port, name)(str(root), resolution=16, **kw)
    want = getattr(ref, name)(str(root), resolution=16, **kw)
    assert len(got) == len(want) == 2 * len(SIZES)
    for a, b in zip(_samples(got), _samples(want)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("name", ["LSUNTrain", "LSUNValidation"])
def test_lsun_needs_lmdb_in_both(folder, name):
    for module in (lsun, jax_lsun):
        with pytest.raises(ImportError, match="lmdb"):
            getattr(module, name)(str(folder))


def test_load_image_matches_jax(folder):
    for path in sorted(folder.glob("train/*/*")):
        np.testing.assert_array_equal(transforms.load_image(str(path)),
                                      jax_transforms.load_image(str(path)))


needs_decoders = pytest.mark.skipif(
    not jax_native.has_decoders(),
    reason="the native library built without libjpeg / libpng")


@needs_decoders
def test_native_decode_matches_jax(folder):
    assert native.has_decoders()
    paths = sorted(folder.glob("train/*/*"))
    blobs = [p.read_bytes() for p in paths]
    for b in blobs:
        assert native.decode_dims(b) == jax_native.decode_dims(b)
        np.testing.assert_array_equal(native.decode_image(b),
                                      jax_native.decode_image(b))
    n = len(blobs)
    args = (blobs, 16, 16, list(range(n)), [n - i for i in range(n)],
            [i % 2 for i in range(n)])
    got, ok = native.decode_pipeline_batch(*args)
    want, ok_want = jax_native.decode_pipeline_batch(*args)
    np.testing.assert_array_equal(ok, ok_want)
    assert ok.all()
    np.testing.assert_array_equal(got, want)


@needs_decoders
@pytest.mark.parametrize("name", ["ClassImageTrain", "ClassImageValidation"])
def test_get_batch_matches_jax(folder, name):
    got = getattr(classimage, name)(str(folder), resolution=16)
    want = getattr(jax_classimage, name)(str(folder), resolution=16)
    idx = [5, 0, 3, 7, 2]
    random.seed(7)
    a = got.get_batch(idx)
    random.seed(7)
    b = want.get_batch(idx)
    for k in ("image", "class"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["image"].shape == (5, 16, 16, 3)
