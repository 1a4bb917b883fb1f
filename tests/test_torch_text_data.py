"""The port's caption datasets and a text-conditioned prior against the
JAX package's, on the CPU.

The test writes small PNG images (lossless, so both packages decode the
same pixels), caption files, CC3M lists and a COCO layout with
segmentation maps; each sample is drawn by both packages after the same
``random.seed``, so the random crops, flips and caption choices line up.
Tokens, images and one-hot maps must be equal. A tiny ``CondTransformer``
conditioned on ``TextCond`` gives JAX's loss within 1e-5 on a caption
batch.
"""
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from enhancing_tpu.data.cc3m import CC3MTrain as JaxCC3MTrain
from enhancing_tpu.data.cc3m import CC3MValidation as JaxCC3MValidation
from enhancing_tpu.data.coco import CocoTrain as JaxCocoTrain
from enhancing_tpu.data.coco import CocoValidation as JaxCocoValidation
from enhancing_tpu.data.textimage import TextImageTrain as JaxTextImageTrain
from enhancing_tpu.data.textimage import \
    TextImageValidation as JaxTextImageValidation
from enhancing_tpu.utils.config import initialize_from_config as jax_init
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import load_gpt_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.data import (CC3MTrain, CC3MValidation, CocoTrain,
                                      CocoValidation, TextImageTrain,
                                      TextImageValidation)
from enhancing_tpu_torch.data.base import _stack
from enhancing_tpu_torch.models.cond import TextCond
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
CAPTIONS = ["A red bus crossing a bridge at night.",
            "Two cats asleep on a sofa; it's warm.",
            "Café au lait & croissants, 2 plates",
            "a photo of a dog catching a frisbee in the park",
            "東京の夜景",
            "An old map of the world, ½ scale"]
SIZES = [(40, 56), (64, 48), (30, 30), (36, 80), (50, 50), (33, 47)]
TEXT_LEN = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(path: Path, shape, rng, mode="RGB", high=256):
    path.parent.mkdir(parents=True, exist_ok=True)
    array = rng.integers(0, high, shape).astype(np.uint8)
    Image.fromarray(array, mode).save(path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("captions")
    text = root / "textimage"
    for i, (h, w) in enumerate(SIZES):
        _png(text / "sub" / f"img{i}.png", (h, w, 3), rng)
        lines = CAPTIONS[i:] + CAPTIONS[:i] if i % 2 else [CAPTIONS[i]]
        (text / f"img{i}.txt").write_text("\n".join(lines) + "\n")
    (text / "img2.txt").write_text("\n \n")              # no caption
    (text / "broken.png").write_bytes(b"not a png")       # unreadable
    (text / "broken.txt").write_text("a caption of nothing")

    cc3m = root / "cc3m"
    for split in ("train", "val"):
        lines = []
        for i, (h, w) in enumerate(SIZES):
            _png(cc3m / "images" / f"{split}{i}.png", (h, w, 3), rng)
            lines.append(f"images/{split}{i}.png\t{CAPTIONS[i]}")
        lines.insert(2, f"images/missing.png\t{CAPTIONS[0]}")
        (cc3m / f"{split}_list.txt").write_text("\n".join(lines) + "\n\n")

    coco = root / "coco"
    for split in ("train2017", "val2017"):
        images, anns = [], []
        for i, (h, w) in enumerate(SIZES[:4]):
            name = f"{i:012d}.jpg.png"
            _png(coco / split / name, (h, w, 3), rng)
            _png(coco / "annotations" / f"stuffthingmaps_{split}"
                 / (Path(name).stem + ".png"), (h, w), rng, "L", 200)
            images.append({"id": 10 + i, "file_name": name})
            for j in range(1 + i % 3):
                anns.append({"image_id": 10 + i,
                             "caption": CAPTIONS[(i + j) % len(CAPTIONS)]})
        (coco / "annotations" / f"captions_{split}.json").write_text(
            json.dumps({"images": images, "annotations": anns}))
    return {"textimage": text, "cc3m": cc3m, "coco": coco}


def _same_samples(jax_ds, port_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        random.seed(100 + i)
        want = jax_ds[i]
        random.seed(100 + i)
        got = port_ds[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    return got


@pytest.mark.parametrize("port_cls, jax_cls, kwargs", [
    (TextImageTrain, JaxTextImageTrain, {"shuffle_captions": True}),
    (TextImageValidation, JaxTextImageValidation, {}),
])
def test_text_image_matches_jax(roots, port_cls, jax_cls, kwargs):
    """Stems paired across folders, the caption-less and the unreadable
    samples replaced by the next one's."""
    kw = dict(root=str(roots["textimage"]), resolution=32, text_len=TEXT_LEN,
              **kwargs)
    got = _same_samples(jax_cls(**kw), port_cls(**kw))
    assert got["image"].shape == (32, 32, 3)
    assert got["caption"].shape == (TEXT_LEN,)


@pytest.mark.parametrize("port_cls, jax_cls", [
    (CC3MTrain, JaxCC3MTrain), (CC3MValidation, JaxCC3MValidation)])
def test_cc3m_matches_jax(roots, port_cls, jax_cls):
    """A list line whose image is missing is replaced by the next one."""
    kw = dict(root=str(roots["cc3m"]), resolution=24, text_len=TEXT_LEN,
              truncate_captions=True)
    got = _same_samples(jax_cls(**kw), port_cls(**kw))
    assert got["image"].shape == (24, 24, 3)


@pytest.mark.parametrize("port_cls, jax_cls", [
    (CocoTrain, JaxCocoTrain), (CocoValidation, JaxCocoValidation)])
def test_coco_with_segmentation_matches_jax(roots, port_cls, jax_cls):
    """Captions, and one-hot maps cut by the image's resize and crop (ids
    past n_labels clipped to the last)."""
    kw = dict(root=str(roots["coco"]), resolution=32, text_len=TEXT_LEN,
              use_segmentation=True, crop_size=24)
    got = _same_samples(jax_cls(**kw), port_cls(**kw))
    assert got["image"].shape == (24, 24, 3)
    assert got["segmentation"].shape == (24, 24, 183)
    np.testing.assert_array_equal(got["segmentation"].sum(-1), 1.0)
    no_seg = dict(kw, use_segmentation=False)
    _same_samples(jax_cls(**no_seg), port_cls(**no_seg))


def _text_prior_config(load):
    """configs/fake_gpt_tiny.yaml conditioned on captions: ``TextCond``
    over the CLIP vocabulary, ``TEXT_LEN`` condition tokens."""
    cfg = load(REPO / "configs" / "fake_gpt_tiny.yaml").model.to_dict()
    params = cfg["params"]
    params["cond_key"] = "caption"
    params["cond"] = {
        "target": cfg["target"].split("models.")[0] + "models.cond.TextCond",
        "params": {"image_size": 32}}
    params["transformer"]["params"].update(vocab_cond_size=49408,
                                           cond_num_tokens=TEXT_LEN)
    return cfg


def test_text_cond_transformer_loss_matches_jax(roots):
    jm = jax_init(_text_prior_config(jax_load_config))
    pm = initialize_from_config(_text_prior_config(load_config),
                                device="cpu")
    assert isinstance(pm.cond_model, TextCond)
    load_gpt_from_jax(pm, jax.tree_util.tree_map(np.asarray, jm.params))
    load_vitvq_from_jax(pm.stage1_model, jax.tree_util.tree_map(
        np.asarray, jm.stage1_model.params))
    ds = TextImageValidation(root=str(roots["textimage"]), resolution=32,
                             text_len=TEXT_LEN)
    batch = _stack([ds[i] for i in range(len(ds))])
    want = float(jm.loss_fn(jm.params, *jm.encode_inputs(batch)))
    with torch.no_grad():
        got = float(pm.shared_step(batch))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5, (got, want)
