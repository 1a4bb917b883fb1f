"""The port's stage-1 tokenizer against the JAX package's, on the CPU.

The JAX ``ViTVQ(seed=0)`` parameters are carried into the port with
``compat.from_jax.load_vitvq_from_jax``; images are made with numpy from a
seed and handed to both. The port runs on ``device="cpu"``, so every op
takes its plain PyTorch version. All in f32.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage1.vitvqgan import ViTVQ as JaxViTVQ
from enhancing_tpu.models.stage1.vitvqgan import ViTVQGumbel as JaxViTVQGumbel
from enhancing_tpu_torch.compat.from_jax import load_vitvq_from_jax
from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ, ViTVQGumbel
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
TINY_TOWER = dict(dim=64, depth=2, heads=2, mlp_dim=128)
TINY = dict(image_size=32, patch_size=8, encoder=TINY_TOWER,
            decoder=TINY_TOWER, quantizer=dict(embed_dim=16, n_embed=128))
# f32 through a few layers, another summation order on each side
REC_TOL = dict(atol=2e-5, rtol=1e-5)


def _pair(jax_cls, torch_cls, **kw):
    jm = jax_cls(seed=0, **kw)
    tm = torch_cls(device="cpu", **kw)
    load_vitvq_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _images(batch, size, seed=0):
    return np.random.default_rng(seed).random((batch, size, size, 3),
                                              dtype=np.float32)


@pytest.fixture(scope="module")
def tiny():
    return _pair(JaxViTVQ, ViTVQ, **TINY)


def test_encode_codes_equal(tiny):
    jm, tm = tiny
    x = _images(4, 32)
    codes = tm.encode_codes(x)
    assert codes.dtype == torch.int32 and codes.shape == (4, 16)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jm.encode_codes(x)))


def test_decode_codes_close(tiny):
    jm, tm = tiny
    codes = np.random.default_rng(1).integers(0, 128, (3, 16)).astype(np.int32)
    rec = tm.decode_codes(codes)
    assert rec.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jm.decode_codes(codes)),
                               **REC_TOL)


def test_call_close(tiny):
    jm, tm = tiny
    x = _images(2, 32, seed=2)
    rec, qloss = tm(x)
    rec_j, qloss_j = jm(x)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), **REC_TOL)
    np.testing.assert_allclose(float(qloss), float(qloss_j), rtol=1e-5)


def test_nchw_input_is_transposed(tiny):
    _, tm = tiny
    x = _images(2, 32, seed=3)
    np.testing.assert_array_equal(
        tm.encode_codes(np.transpose(x, (0, 3, 1, 2))).numpy(),
        tm.encode_codes(x).numpy())


def test_log_images(tiny):
    _, tm = tiny
    out = tm.log_images({"image": _images(1, 32, seed=4)})
    assert out["originals"].shape == out["reconstructions"].shape \
        == (1, 32, 32, 3)


def test_residual_quantizer_matches_jax():
    kw = dict(TINY, quantizer=dict(embed_dim=16, n_embed=128,
                                   use_residual=True, num_quantizers=2))
    jm, tm = _pair(JaxViTVQ, ViTVQ, **kw)
    x = _images(2, 32, seed=5)
    codes = tm.encode_codes(x)
    assert codes.shape == (2, 16, 2)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jm.encode_codes(x)))
    np.testing.assert_allclose(tm.decode_codes(codes).numpy(),
                               np.asarray(jm.decode_codes(codes.numpy())),
                               **REC_TOL)
    rec, qloss = tm(x)
    rec_j, qloss_j = jm(x)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), **REC_TOL)
    np.testing.assert_allclose(float(qloss), float(qloss_j), rtol=1e-5)


def test_gumbel_deterministic_path_matches_jax():
    kw = dict(TINY, quantizer=dict(embed_dim=16, n_embed=128, temp_init=1.0))
    jm, tm = _pair(JaxViTVQGumbel, ViTVQGumbel, **kw)
    x = _images(2, 32, seed=6)
    np.testing.assert_array_equal(tm.encode_codes(x).numpy(),
                                  np.asarray(jm.encode_codes(x)))
    rec, qloss = tm(x)
    rec_j, qloss_j = jm(x)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), **REC_TOL)
    np.testing.assert_allclose(float(qloss), float(qloss_j), rtol=1e-5)


def test_gumbel_noise_comes_from_the_generator():
    tm = ViTVQGumbel(device="cpu", **dict(
        TINY, quantizer=dict(embed_dim=16, n_embed=128)))
    h = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(0))
    quant = tm.module.quantizer

    def draw():
        return quant(h, deterministic=False,
                     generator=torch.Generator().manual_seed(7))[2]

    np.testing.assert_array_equal(draw().numpy(), draw().numpy())


def test_full_widths_codes_equal_outside_near_ties():
    """ViT-VQGAN-Base widths (N = 1024 tokens, 12 heads of 64, 8192 codes
    of 32) at depth 2 and batch 1: codes equal at every token except
    where JAX's best two scores lie within 1e-5 of each other."""
    tower = dict(dim=768, depth=2, heads=12, mlp_dim=3072)
    kw = dict(image_size=256, patch_size=8, encoder=tower, decoder=tower,
              quantizer=dict(embed_dim=32, n_embed=8192))
    jm, tm = _pair(JaxViTVQ, ViTVQ, **kw)
    x = _images(1, 256, seed=7)
    codes_j = np.asarray(jm.encode_codes(x))
    codes = tm.encode_codes(x).numpy()

    module = jm.module
    h = module.apply(jm.variables, jax.numpy.asarray(x),
                     method=lambda m, x: m.pre_quant(m.enc(x)))
    z = np.asarray(h, np.float64).reshape(-1, 32)
    z /= np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-12)
    e = np.asarray(jm.params["quantizer"]["embedding"], np.float64)
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
    scores = (e * e).sum(-1)[None] - 2.0 * z @ e.T
    best2 = np.sort(scores, axis=-1)[:, :2]
    near_tie = (best2[:, 1] - best2[:, 0]) <= 1e-5

    mismatch = codes.reshape(-1) != codes_j.reshape(-1)
    print(f"full widths: {int(near_tie.sum())} near-tie tokens, "
          f"{int(mismatch.sum())} mismatches")
    assert not (mismatch & ~near_tie).any()
    rec = tm.decode_codes(codes_j)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jm.decode_codes(
        codes_j)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["fake_vitvq_tiny", "imagenet_vitvq_base"])
def test_yaml_configs_build_port_models(name):
    cfg = load_config(REPO / "configs" / f"{name}.yaml")
    assert cfg.model.target == \
        "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ"
    model = initialize_from_config(cfg.model, device="cpu")
    assert isinstance(model, ViTVQ)
    # the loss is the training slice's: kept as a dict, remapped, not built
    assert isinstance(model.loss, dict)
    assert model.loss["target"].startswith("enhancing_tpu_torch.losses.")
    size = cfg.model.params.image_size
    codes = model.encode_codes(np.zeros((1, size, size, 3), np.float32))
    assert codes.shape == (1, (size // 8) ** 2)


def test_model_without_device_raises_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViTVQ(**TINY)


BLOCKER = """
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "enhancing_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import numpy as np
import enhancing_tpu_torch
from enhancing_tpu_torch.models.stage1 import ViTVQ
from enhancing_tpu_torch.compat import load_vitvq_from_jax
from enhancing_tpu_torch.ops import cuda_lib
from enhancing_tpu_torch.utils import load_config
tower = dict(dim=64, depth=1, heads=2, mlp_dim=128)
m = ViTVQ(image_size=16, patch_size=8, encoder=tower, decoder=tower,
          quantizer=dict(embed_dim=16, n_embed=32), device="cpu")
rec = m.decode_codes(m.encode_codes(np.zeros((1, 16, 16, 3), np.float32)))
assert tuple(rec.shape) == (1, 16, 16, 3)
assert not any(k.split(".")[0] in ("jax", "flax", "enhancing_tpu")
               for k in sys.modules)
print("ok")
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
