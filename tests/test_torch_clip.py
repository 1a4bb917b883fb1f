"""The port's CLIP towers, checkpoint loader and conditioners against the
JAX package's, on the CPU at tiny widths.

``tests/test_cond.py``'s ``_torch_clip_tiny`` (width 64, 2 layers, 2
heads, patch 8, 32 px, context 16) gives both the tiny configuration and
a torch CLIP with the OpenAI state-dict layout. Features are held within
1e-4 of JAX's ``apply`` (fp32 sums in another order over two blocks).
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cond import _torch_clip_tiny

from enhancing_tpu.models.cond import clip as jax_clip
from enhancing_tpu.models.cond import clipcond as jax_clipcond
from enhancing_tpu.models.cond.dummycond import TextCond as JaxTextCond
from enhancing_tpu_torch.compat import load_clip_from_jax, to_jax_tree
from enhancing_tpu_torch.models.cond import (ClipImageCond, ClipTextCond,
                                             TextCond, clip, clipcond)

FEATURE_TOL = dict(rtol=0, atol=1e-4)
TOWERS = {"visual": (jax_clip.CLIPVisionTransformer,
                     clip.CLIPVisionTransformer),
          "text": (jax_clip.CLIPTextTransformer, clip.CLIPTextTransformer)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(torch CLIP, JAX config, port config, its checkpoint's path)."""
    model, jax_cfg = _torch_clip_tiny()
    port_cfg = clip.CLIPConfig(**dataclasses.asdict(jax_cfg))
    path = tmp_path_factory.mktemp("clip") / "clip.pt"
    torch.save(model.state_dict(), path)
    return model, jax_cfg, port_cfg, str(path)


def _inputs(which, cfg, seed=0):
    rng = np.random.default_rng(seed)
    if which == "visual":
        res = cfg.image_resolution
        return rng.standard_normal((2, res, res, 3)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size - 1, (2, cfg.context_length))
    toks[0, 5] = toks[1, -1] = cfg.vocab_size - 1   # EOT: the maximum id
    toks[1, 3] = cfg.vocab_size - 1                 # the first one counts
    return toks.astype(np.int32)


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(np.asarray(x))).numpy()


@functools.lru_cache()
def _jax_params(which, cfg):
    x = _inputs(which, cfg)[:1]
    params = TOWERS[which][0](cfg).init(jax.random.PRNGKey(7), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("which", ["visual", "text"])
def test_tower_matches_jax_apply(tiny, which):
    """JAX-drawn parameters carried across by ``load_clip_from_jax``."""
    _, jax_cfg, port_cfg, _ = tiny
    jax_tower, port_tower = TOWERS[which]
    params = _jax_params(which, jax_cfg)
    port = load_clip_from_jax(port_tower(port_cfg, device="cpu"), params)
    x = _inputs(which, jax_cfg, seed=1)
    want = np.asarray(jax_tower(jax_cfg).apply({"params": params}, x))
    got = _port(port, x)
    assert got.shape == (2, jax_cfg.embed_dim)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


@pytest.mark.parametrize("which", ["visual", "text"])
def test_jax_tree_of_tower_matches_jax(tiny, which):
    """``to_jax_tree`` names and lays out the port's parameters as the JAX
    tower's tree, and inverts ``load_clip_from_jax`` exactly."""
    _, jax_cfg, port_cfg, _ = tiny
    params = _jax_params(which, jax_cfg)
    port = load_clip_from_jax(TOWERS[which][1](port_cfg, device="cpu"),
                              params)
    tree = to_jax_tree(port)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, want)


def test_load_clip_from_jax_is_strict(tiny):
    _, jax_cfg, port_cfg, _ = tiny
    params = _jax_params("visual", jax_cfg)
    tower = clip.CLIPVisionTransformer(port_cfg, device="cpu")
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_clip_from_jax(tower, extra)
    missing = {k: v for k, v in params.items() if k != "proj"}
    with pytest.raises(KeyError):
        load_clip_from_jax(tower, missing)
    wrong = dict(params, proj=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        load_clip_from_jax(tower, wrong)


@pytest.mark.parametrize("which", ["visual", "text"])
def test_load_torch_clip_matches_jax(tiny, which):
    """An OpenAI-layout checkpoint read by both packages' ``load_torch_clip``:
    the same inferred config, the same trees, the same features; with the
    tiny config given (its 2 heads), the torch CLIP's features too."""
    model, jax_cfg, _, path = tiny
    jax_inferred, jax_params = jax_clip.load_torch_clip(path, which)
    port_inferred, towers = clip.load_torch_clip(path, which, device="cpu")
    assert dataclasses.asdict(port_inferred) == \
        dataclasses.asdict(jax_inferred)
    tree = to_jax_tree(towers[which])
    for got, want in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(jax_params[which])):
        np.testing.assert_array_equal(got, want)
    x = _inputs(which, jax_cfg, seed=2)
    want = np.asarray(TOWERS[which][0](jax_inferred).apply(
        {"params": jax_params[which]}, x))
    np.testing.assert_allclose(_port(towers[which], x), want, **FEATURE_TOL)

    _, towers = clip.load_torch_clip(
        path, which, cfg=clip.CLIPConfig(**dataclasses.asdict(jax_cfg)),
        device="cpu")
    with torch.no_grad():
        if which == "visual":
            ref = model.visual(torch.from_numpy(x).permute(0, 3, 1, 2))
        else:
            ref = model.encode_text(torch.from_numpy(x).long())
    np.testing.assert_allclose(_port(towers[which], x), ref.numpy(),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("size", [256, 160])
def test_preprocess_images_matches_jax(size):
    """The antialiased bicubic resize to 224 px and the normalization,
    held within 2e-5 in the [0, 1] units of the input images (the
    normalized difference times CLIP_STD)."""
    x = np.random.default_rng(size).random((2, size, size, 3),
                                           dtype=np.float32)
    got = clip.preprocess_images(torch.from_numpy(x), 224).numpy()
    want = np.asarray(jax_clip.preprocess_images(jnp.asarray(x), 224))
    assert got.shape == want.shape == (2, 224, 224, 3)
    assert np.abs((got - want) * clip.CLIP_STD).max() <= 2e-5


@pytest.mark.parametrize("port_cls, jax_cls, kwargs", [
    (ClipImageCond, jax_clipcond.ClipImageCond, {}),
    (ClipTextCond, jax_clipcond.ClipTextCond, {"image_size": 32}),
])
def test_clip_conds_gated_without_weights(port_cls, jax_cls, kwargs):
    messages = []
    for cls in (jax_cls, port_cls):
        with pytest.raises(RuntimeError, match="no network egress") as err:
            cls(clip_model="ViT-B/32", **kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_clip_conds_work_with_weights(tiny, monkeypatch):
    """Given a checkpoint, both conditioners give JAX's frozen features:
    images through the tower's preprocessing, tokens zero-padded to the
    context length."""
    _, jax_cfg, port_cfg, path = tiny
    monkeypatch.setattr(jax_clipcond, "CLIP_CONFIGS", {"tiny": jax_cfg})
    monkeypatch.setattr(clipcond, "CLIP_CONFIGS", {"tiny": port_cfg})
    rng = np.random.default_rng(3)
    images = rng.random((2, 32, 32, 3), dtype=np.float32)
    toks = np.zeros((2, 8), np.int32)
    toks[:, :3] = rng.integers(1, 90, (2, 3))
    toks[:, 3] = 99
    for port_cls, jax_cls, kwargs, x in (
            (ClipImageCond, jax_clipcond.ClipImageCond, {}, images),
            (ClipTextCond, jax_clipcond.ClipTextCond, {"image_size": 32},
             toks)):
        want = np.asarray(jax_cls(clip_model="tiny", clip_params_path=path,
                                  **kwargs).encode_codes(x))
        cond = port_cls(clip_model="tiny", clip_params_path=path,
                        device="cpu", **kwargs)
        got = cond.encode_codes(x)
        assert not got.requires_grad and got.shape == (2, jax_cfg.embed_dim)
        np.testing.assert_allclose(got.numpy(), want, **FEATURE_TOL)
    np.testing.assert_array_equal(cond.to_img(toks),
                                  JaxTextCond(image_size=32).to_img(toks))


def test_text_cond_to_img_matches_jax():
    """Decoded captions rendered as JAX renders them: (B, H, W, 3) fp32 in
    [0, 1], from numpy ids or a tensor."""
    port, jax_cond = TextCond(image_size=(48, 32)), JaxTextCond((48, 32))
    toks = port.tokenizer.tokenize(["a red bus on a bridge at night",
                                    "two cats"], 16)
    want = jax_cond.to_img(toks)
    got = port.to_img(torch.from_numpy(toks))
    assert got.shape == want.shape == (2, 32, 48, 3)
    assert got.dtype == np.float32 and got.min() >= 0 and got.max() <= 1
    np.testing.assert_array_equal(got, want)
    assert port.encode_codes(toks) is toks


def test_chip_smoke_clip_writer_matches_jax_loader(tiny, tmp_path):
    """``chip_smoke.py`` phase 18's ``openai_clip_state_dict`` of seeded
    port towers, read by JAX's ``load_torch_clip``: the towers' own trees
    and the config they imply."""
    _, jax_cfg, port_cfg, _ = tiny
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    text = clip.CLIPTextTransformer(port_cfg, seed=1, device="cpu")
    vision = clip.CLIPVisionTransformer(port_cfg, seed=2, device="cpu")
    path = tmp_path / "written.pt"
    torch.save(smoke.openai_clip_state_dict(text, vision), path)
    _, params = jax_clip.load_torch_clip(str(path), cfg=jax_cfg)
    for name, tower in (("text", text), ("visual", vision)):
        tree = to_jax_tree(tower)
        assert jax.tree_util.tree_structure(params[name]) == \
            jax.tree_util.tree_structure(tree)
        for got, want in zip(jax.tree_util.tree_leaves(params[name]),
                             jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(got, want)
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    assert dataclasses.asdict(jax_clip.clip_config_from_state_dict(sd)) == \
        dataclasses.asdict(dataclasses.replace(
            jax_cfg, transformer_heads=jax_cfg.transformer_width // 64,
            vision_heads_override=None))
