"""The port's evaluation metrics and InceptionV3 against the JAX package's,
on the CPU.

``psnr``, ``ssim`` and ``codebook_usage`` on the same arrays agree to
float32 rounding; ``FrechetDistance`` on the same features to 1e-9
relative (both fp64); ``vgg_feature_fn`` on the same trunk to 1e-5.
``InceptionV3Pool3`` runs at 299 px, batch 2, with weights and BatchNorm
statistics drawn by numpy in the JAX tree's names and shapes (the JAX
module's jitted apply checks them) and carried in by
``compat.load_inception_from_jax``: pool3 features within 2e-5 absolute.
The 299-px resize (``F.interpolate``, bilinear, no antialiasing) equals
``jax.image.resize(..., "bilinear", antialias=False)`` within 1e-6, up
and down. A torchvision-layout state dict loads strictly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.eval import metrics as jax_metrics
from enhancing_tpu.eval.inception import InceptionV3Pool3 as JaxInception
from enhancing_tpu.eval.inception import fid_feature_fn as jax_fid_feature_fn
from enhancing_tpu.losses.lpips import LPIPS as JaxLPIPS
from enhancing_tpu_torch.compat import load_inception_from_jax, to_jax_tree
from enhancing_tpu_torch.eval import (FrechetDistance, codebook_usage,
                                      fid_feature_fn, init_inception, psnr,
                                      ssim, vgg_feature_fn)
from enhancing_tpu_torch.eval.inception import (InceptionV3Pool3,
                                                load_torch_inception,
                                                resize_299)
from enhancing_tpu_torch.losses.lpips import LPIPS

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, shape=(3, 32, 40, 3)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape).astype(np.float32), 0, 1)
    return x, y


def test_psnr_ssim_match_jax():
    x, y = _pair()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(psnr(tx, ty).numpy(),
                               np.asarray(jax_metrics.psnr(x, y)), **F32)
    np.testing.assert_allclose(ssim(tx, ty).numpy(),
                               np.asarray(jax_metrics.ssim(x, y)), **F32)
    np.testing.assert_allclose(psnr(tx, tx).numpy(), 120.0)
    np.testing.assert_allclose(ssim(tx, tx).numpy(), 1.0, rtol=1e-6)


def test_codebook_usage_matches_jax():
    codes = np.random.default_rng(1).integers(0, 50, (4, 16))
    want = jax_metrics.codebook_usage(codes, 64)
    assert codebook_usage(torch.from_numpy(codes), 64) == want
    assert codebook_usage(codes, 64) == want


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(6, 5, 4)).astype(np.float32) + i
             for i in range(4)]
    got = FrechetDistance(lambda v: torch.as_tensor(v).reshape(len(v), -1))
    want = jax_metrics.FrechetDistance(lambda v: v)
    for i, f in enumerate(feats):
        (got.update_real if i % 2 else got.update_fake)(f)
        (want.update_real if i % 2 else want.update_fake)(f)
    np.testing.assert_allclose(got.compute(), want.compute(), rtol=1e-9)


def test_vgg_feature_fn_matches_jax():
    lpips = LPIPS(torch.Generator().manual_seed(3))
    x, _ = _pair(4, (2, 32, 32, 3))
    got = vgg_feature_fn(lpips)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_metrics.vgg_feature_fn(JaxLPIPS(), to_jax_tree(
        lpips))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(37, 53), (400, 320)])
def test_resize_matches_jax(size):
    x = np.random.default_rng(5).random((2, *size, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear", antialias=False))
    np.testing.assert_allclose(resize_299(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=1e-6)


def _jax_inception_tree(module, rng):
    """Random weights and BatchNorm statistics in the JAX module's names
    and layouts (HWIO kernels), shaped after the port's module."""
    tree = {}
    for name, sub in module.named_modules():
        if not hasattr(sub, "bn") or not hasattr(sub, "conv"):
            continue
        o, i, h, w = sub.conv.weight.shape
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["kernel"] = (rng.normal(size=(h, w, i, o))
                          / np.sqrt(h * w * i)).astype(np.float32)
        node["scale"] = rng.uniform(0.8, 1.2, o).astype(np.float32)
        node["bias"] = rng.normal(0, 0.1, o).astype(np.float32)
        node["mean"] = rng.normal(0, 0.1, o).astype(np.float32)
        node["var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def inception_pair():
    port = InceptionV3Pool3().eval()
    tree = _jax_inception_tree(port, np.random.default_rng(6))
    load_inception_from_jax(port, tree)
    return port, tree


def test_inception_features_match_jax(inception_pair):
    port, tree = inception_pair
    x = np.random.default_rng(7).random((2, 64, 48, 3), dtype=np.float32)
    want = np.asarray(jax_fid_feature_fn(JaxInception(), tree)(
        jnp.asarray(x)))
    got = fid_feature_fn(port)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_torchvision_layout_loads_strictly(inception_pair, tmp_path):
    port, _ = inception_pair
    sd = {k: v.clone() for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    # a torchvision / pytorch-fid file also holds the classifier
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    path = tmp_path / "pt_inception.pth"
    torch.save({"state_dict": sd}, path)
    loaded = init_inception(weights_path=str(path), device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training
    missing = dict(sd)
    missing.pop("Mixed_6b.branch7x7_2.bn.running_var")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_torch_inception(missing, InceptionV3Pool3())
    extra = dict(sd, **{"Mixed_6b.extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_torch_inception(extra, InceptionV3Pool3())
