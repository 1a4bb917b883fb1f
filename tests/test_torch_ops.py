"""The port's ops (enhancing_tpu_torch.ops) against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both. JAX runs each
op through its Pallas kernel in interpret mode (``impl="pallas"`` under
ENHANCING_TPU_PALLAS_INTERPRET=1) and through its XLA twin
(``impl="xla"``); the port runs its plain PyTorch versions, which is what
CPU tensors dispatch to. Everything is f32; each tolerance is stated at
its assert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.ops import ln_gemm as jlg
from enhancing_tpu.ops import vq as jvq
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.ops import common as tcommon
from enhancing_tpu_torch.ops import ln_gemm as tlg
from enhancing_tpu_torch.ops import vq as tvq

# f32 with another summation order on each side: a few ulps of O(1) values
F32_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ln_inputs(rng, shape):
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", [None, "tanh", "sqrelu", "gelu"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fused_ln_gemm_matches_jax(interpret, impl, activation, with_bias):
    rng = np.random.default_rng(0)
    m, d, n = 48, 256, 384
    x, gamma, beta = _ln_inputs(rng, (m, d))
    w = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32) if with_bias else None
    ref = jlg.fused_ln_gemm(jnp.asarray(x), jnp.asarray(gamma),
                            jnp.asarray(beta), jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            activation=activation, impl=impl)
    out = tlg.fused_ln_gemm(_t(x), _t(gamma), _t(beta), _t(w.T),
                            None if b is None else _t(b),
                            activation=activation)
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fused_layernorm_matches_jax(interpret, impl):
    rng = np.random.default_rng(1)
    x, gamma, beta = _ln_inputs(rng, (3, 40, 256))
    ref = jlg.fused_layernorm(jnp.asarray(x), jnp.asarray(gamma),
                              jnp.asarray(beta), impl=impl)
    out = tlg.fused_layernorm(_t(x), _t(gamma), _t(beta))
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


# the shapes and modes of tests/test_ops.py::test_attention_packed_qkv_
# matches_split
PACKED_CASES = [
    ((2, 64, 4, 64), "none", 0),
    ((1, 64, 2, 128), "none", 0),
    ((1, 33, 4, 64), "prefix_causal", 3),
    ((2, 40, 8, 32), "prefix_causal", 2),
]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape,mode,cl", PACKED_CASES)
def test_attention_packed_qkv_matches_jax(interpret, shape, mode, cl, impl):
    b, n, h, d = shape
    rng = np.random.default_rng(2)
    qkv = (rng.standard_normal((b, n, 3 * h * d)) * 0.3).astype(np.float32)
    ref = jatt.multihead_attention_packed_qkv(
        jnp.asarray(qkv), h, d, mask_mode=mode, cond_len=cl, impl=impl)
    out = tatt.multihead_attention_packed_qkv(_t(qkv), h, d, mask_mode=mode,
                                              cond_len=cl)
    assert out.shape == (b, n, h * d)
    # the tolerance of the JAX package's own packed-qkv test
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=1e-4)


def test_nearest_codebook_indices_matches_jax(interpret):
    rng = np.random.default_rng(3)
    m, n, d = 300, 1000, 32  # deliberately unaligned
    z = rng.standard_normal((m, d)).astype(np.float32)
    codebook = rng.standard_normal((n, d)).astype(np.float32)
    ref_pallas = jvq._nearest_pallas(jnp.asarray(z), jnp.asarray(codebook),
                                     block_m=128, block_n=256)
    ref_xla = jvq.nearest_codebook_indices(jnp.asarray(z),
                                           jnp.asarray(codebook), impl="xla")
    out = tvq.nearest_codebook_indices(_t(z), _t(codebook))
    assert out.dtype == torch.int32 and out.shape == (m,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_pallas))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_xla))


def test_nearest_codebook_indices_ties_go_to_the_lowest_index():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((50, 16)).astype(np.float32)
    codebook = np.concatenate([base, base, base])  # every code three times
    z = base[rng.integers(0, 50, size=200)] \
        + 0.01 * rng.standard_normal((200, 16)).astype(np.float32)
    out = tvq.nearest_codebook_indices(_t(z), _t(codebook)).numpy()
    ref = np.asarray(jvq.nearest_codebook_indices(
        jnp.asarray(z), jnp.asarray(codebook), impl="xla"))
    assert (out < 50).all()
    np.testing.assert_array_equal(out, ref)


def test_l2_normalize_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((10, 32)).astype(np.float32)
    x[3] = 0.0  # a zero row must not give NaN
    out = tvq.l2_normalize(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jvq.l2_normalize(
        jnp.asarray(x))), atol=1e-6)
    assert not np.isnan(out).any()


def test_codebook_distances_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 5, 8)).astype(np.float32)
    e = rng.standard_normal((7, 8)).astype(np.float32)
    out = tvq.codebook_distances(_t(z), _t(e)).numpy()
    ref = np.asarray(jvq.codebook_distances(jnp.asarray(z), jnp.asarray(e)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    x = torch.zeros(4, 8)
    assert tcommon.use_kernel(x, None, x) is False
    before = dict(tcommon.LAUNCHES)
    tlg.fused_layernorm(x, torch.ones(8), torch.zeros(8))
    assert tcommon.LAUNCHES == before
    with pytest.raises(ValueError):
        tcommon.use_kernel(x, torch.zeros(2, device="meta"))
