"""The port's user scripts (``enhancing_tpu_torch.scripts``) against the JAX
package's ``scripts/*.py``, on the CPU.

One reference-format (Lightning) checkpoint of a seeded tiny tokenizer,
written as ``tests/test_torch_checkpoints.py`` writes one (the torch
clone of ``tests/test_compat.py`` with the reference's state-dict names),
goes to both packages' ``reconstruct`` and ``evaluate`` through
``--ckpt``, from a working directory whose ``configs/tiny_ckpt.yaml``
(written with the port's YAML writer) names that tokenizer and a
FakeImages validation split. The codes agree exactly, the reconstructions
within 2e-4 (``tests/test_torch_checkpoints.py``'s bar) and PSNR / SSIM /
codebook usage within 1e-4 relative. ``sample`` and ``eval_samples`` run
on ``configs/fake_gpt_tiny.yaml``.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from test_compat import TorchViTVQ

from enhancing_tpu_torch.scripts import (eval_samples, evaluate,
                                         reconstruct, sample)
from enhancing_tpu_torch.utils import yaml_io

REPO = Path(__file__).resolve().parents[1]
TOWER = dict(dim=64, depth=2, heads=2, mlp_dim=128)
CONFIG = {
    "model": {
        "target": "enhancing_tpu.models.stage1.vitvqgan.ViTVQ",
        "params": {"image_key": "image", "image_size": 32, "patch_size": 8,
                   "encoder": TOWER, "decoder": TOWER,
                   "quantizer": {"embed_dim": 16, "n_embed": 64},
                   "loss": {"target": "enhancing_tpu.losses.vqperceptual."
                                      "DummyLoss"}}},
    "dataset": {
        "target": "enhancing_tpu.data.DataModuleFromConfig",
        "params": {"batch_size": 4, "num_workers": 2,
                   "validation": {"target": "enhancing_tpu.data.fake."
                                            "FakeImages",
                                  "params": {"length": 8, "resolution": 32,
                                             "seed": 3}}}},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory with the config, the checkpoint and images."""
    d = tmp_path_factory.mktemp("scripts")
    (d / "configs").mkdir()
    yaml_io.dump(CONFIG, d / "configs" / "tiny_ckpt.yaml")
    (d / "assets").symlink_to(REPO / "assets")
    torch.manual_seed(0)
    torch.save({"state_dict": TorchViTVQ().eval().state_dict()},
               d / "model.ckpt")
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 36), (32, 50), (33, 33)]):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            d / f"im{i}.{'png' if i % 2 else 'jpg'}")
    return d


def _run_jax(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _jax_script(name).main()
    return capsys.readouterr().out


def test_reconstruct_matches_jax(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    images = sorted(str(p) for p in workdir.glob("im*"))
    common = ["-c", "tiny_ckpt", "--ckpt", "model.ckpt", *images]
    got = reconstruct.main([*common, "-o", "port_rec", "--device", "cpu"])
    _run_jax("reconstruct", [*common, "-o", "jax_rec"], monkeypatch, capsys)
    want_codes = np.load("jax_rec/codes.npy")
    np.testing.assert_array_equal(np.load("port_rec/codes.npy"), want_codes)
    np.testing.assert_array_equal(got["codes"], want_codes)
    for p in images:
        stem = Path(p).stem
        a = np.asarray(Image.open(f"port_rec/{stem}_recon.png"))
        b = np.asarray(Image.open(f"jax_rec/{stem}_recon.png"))
        assert a.shape == b.shape == (36, 70, 3)
        # uint8 grids of reconstructions 2e-4 apart: a level at most
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_evaluate_matches_jax(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    common = ["-c", "tiny_ckpt", "--ckpt", "model.ckpt", "--max-batches", "2"]
    got = evaluate.main([*common, "--device", "cpu"])
    capsys.readouterr()
    printed = _run_jax("evaluate", common, monkeypatch, capsys)
    want = json.loads(printed[printed.index("{"):])
    assert got.keys() == want.keys()
    assert got["num_images"] == want["num_images"] == 8
    for k in ("codebook_usage", "codebook_n_used", "codebook_perplexity"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    for k in ("psnr", "ssim"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_sample_and_eval_samples_run(workdir, monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    out = sample.main(["-c", "fake_gpt_tiny", "--classes", "1", "7",
                       "-n", "2", "--top_k", "8", "-o", str(tmp_path),
                       "--device", "cpu"])
    assert out["pixels"].shape == (4, 32, 32, 3)
    assert out["codes"].shape == (4, 16)
    assert 0.0 <= out["pixels"].min() and out["pixels"].max() <= 1.0
    grid = np.asarray(Image.open(tmp_path / "samples.png"))
    assert grid.shape == (2 + 2 * 34, 2 + 2 * 34, 3)
    with pytest.raises(NotImplementedError, match="A9"):
        sample.main(["-c", "fake_gpt_tiny", "--shard", "--device", "cpu"])
    res = eval_samples.main(["-c", "fake_gpt_tiny", "--num_samples", "8",
                             "--batch", "8", "--top_k", "8",
                             "--device", "cpu"])
    assert res["num_samples"] == res["num_real"] == 8
    assert res["feature_trunk"] == "vgg16_random_init"
    assert np.isfinite(res["frechet_distance"])
    assert not os.path.exists(REPO / "samples")
