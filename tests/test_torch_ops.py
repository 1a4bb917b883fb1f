"""The port's ops (enhancing_tpu_torch.ops) against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both. JAX runs each
op through its Pallas kernel in interpret mode (``impl="pallas"`` under
ENHANCING_TPU_PALLAS_INTERPRET=1) and through its XLA twin
(``impl="xla"``); the port runs its plain PyTorch versions, which is what
CPU tensors dispatch to. Everything is f32; each tolerance is stated at
its assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.ops import cache as jcache
from enhancing_tpu.ops import fused_act as jfa
from enhancing_tpu.ops import ln_gemm as jlg
from enhancing_tpu.ops import upfirdn2d as jfir
from enhancing_tpu.ops import vq as jvq
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.ops import cache as tcache
from enhancing_tpu_torch.ops import common as tcommon
from enhancing_tpu_torch.ops import fused_act as tfa
from enhancing_tpu_torch.ops import ln_gemm as tlg
from enhancing_tpu_torch.ops import vq as tvq
from enhancing_tpu_torch.ops.upfirdn2d import (make_blur_kernel,
                                               upfirdn2d_plain)

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


# ---- backward of B1 and B3: autograd of the plain version, the path the
# kernels' autograd Functions take on the card (ops.ln_gemm._plain_vjp)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("activation", [None, "tanh", "sqrelu", "gelu"])
def test_fused_ln_gemm_backward_matches_jax(activation):
    rng = np.random.default_rng(10)
    m, d, n = 40, 128, 96
    x, gamma, beta = _ln_inputs(rng, (m, d))
    w = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jlg.fused_ln_gemm(*a, activation=activation),
                     *map(jnp.asarray, (x, gamma, beta, w, b)))
    ref = vjp(jnp.asarray(g))
    ref = (*ref[:3], np.asarray(ref[3]).T, ref[4])  # w in torch's layout
    ins = [_t(a) for a in (x, gamma, beta, w.T, b)]
    via_function = tlg._plain_vjp(
        lambda *t: tlg.ln_gemm_plain(*t, activation),
        [(t, True) for t in ins], _t(g))
    leaves = [t.clone().requires_grad_() for t in ins]
    out = tlg.fused_ln_gemm(*leaves, activation=activation)
    via_entry = torch.autograd.grad(out, leaves, _t(g))
    # f32, sums over m or n rows in another order on each side
    for name, want, a, c in zip(("x", "gamma", "beta", "w", "b"), ref,
                                via_function, via_entry):
        np.testing.assert_allclose(_np(a), np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(_np(c), np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=name)


def test_fused_layernorm_backward_matches_jax():
    rng = np.random.default_rng(11)
    x, gamma, beta = _ln_inputs(rng, (2, 24, 128))
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(jlg.fused_layernorm,
                     *map(jnp.asarray, (x, gamma, beta)))
    ref = vjp(jnp.asarray(g))
    x2 = _t(x.reshape(-1, 128))
    via_function = tlg._plain_vjp(lambda *t: tlg.layernorm(*t),
                                  [(x2, True), (_t(gamma), True),
                                   (_t(beta), True)],
                                  _t(g.reshape(-1, 128)))
    for name, want, got in zip(("x", "gamma", "beta"), ref, via_function):
        np.testing.assert_allclose(_np(got).reshape(np.shape(want)),
                                   np.asarray(want), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


# ---- B5: the attention backward


def _bwd_inputs(rng, b, n, h, d, dtype):
    qkv = (rng.standard_normal((b, n, 3 * h * d)) * 0.5).astype(np.float32)
    do = rng.standard_normal((b, n, h * d)).astype(np.float32)
    q3, k3, v3 = (qkv[..., i * h * d:(i + 1) * h * d] for i in range(3))
    q3 = q3 * d ** -0.5
    return [a.astype(dtype) for a in (q3, k3, v3, do)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 5)])
def test_attention_bwd_plain_matches_jax_kernel(interpret, dtype, mode, cl):
    """The port's plain backward (autograd of the plain attention) against
    the JAX backward kernel run in interpret mode."""
    b, n, h, d = 2, 64, 2, 64
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ins = _bwd_inputs(np.random.default_rng(12), b, n, h, d, np.float32)
    jins = [jnp.asarray(a, jdt) for a in ins]
    ref = jatt._attention_packed_bwd_call(*jins, mode, cl, d)
    tdt = getattr(torch, dtype)
    got = tatt.attention_bwd_plain(*[_t(a).to(tdt) for a in ins], h, d,
                                   mode, cl)
    for name, want, g in zip("qkv", ref, got):
        want = np.asarray(want, np.float32)
        assert g.dtype == tdt
        if dtype == "float32":
            # f32: the same function, another summation order
            np.testing.assert_allclose(_np(g), want, atol=2e-5, rtol=1e-4,
                                       err_msg="d" + name)
        else:
            # bf16: the kernel rounds dS before its products, the plain
            # version's autograd rounds dP instead; one bf16 step (2^-8)
            # on terms summed over 64 keys, held to 2^-6 of the largest
            # value plus 2^-6 relative
            scale = np.abs(want).max()
            np.testing.assert_allclose(_np(g), want,
                                       atol=2.0 ** -6 * scale,
                                       rtol=2.0 ** -6, err_msg="d" + name)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
def test_attention_packed_qkv_gradient_matches_jax(interpret, mode, cl):
    b, n, h, d = 2, 48, 2, 64
    rng = np.random.default_rng(13)
    qkv = (rng.standard_normal((b, n, 3 * h * d)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, n, h * d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jatt.multihead_attention_packed_qkv(
        a, h, d, mask_mode=mode, cond_len=cl, impl="pallas"),
        jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(g))
    leaf = _t(qkv).requires_grad_()
    out = tatt.multihead_attention_packed_qkv(leaf, h, d, mask_mode=mode,
                                              cond_len=cl)
    (got,) = torch.autograd.grad(out, leaf, _t(g))
    # f32 through softmax and three products, another order on each side
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=3e-5,
                               rtol=1e-4)


# ---- B6: the FIR blur

BLUR = np.asarray(make_blur_kernel([1, 3, 3, 1]))


@pytest.mark.parametrize("pad", [(2, 2, 2, 2), (1, 1, 1, 1),
                                 (-1, 2, 0, -2), (3, 0, -1, 1)])
def test_fir_plain_matches_jax_kernel(interpret, pad):
    x = np.random.default_rng(14).standard_normal((2, 9, 11, 16)).astype(
        np.float32)
    k = np.array([[1.0, 2.0, 0.0, 1.0], [0.5, -1.0, 3.0, 0.25],
                  [2.0, 1.0, 1.0, -0.5]], np.float32)
    taps = tuple(tuple(float(v) for v in row) for row in np.flip(k, (0, 1)))
    ref = jfir._upfirdn2d_pallas_fir(jnp.asarray(x), taps, pad)
    got = upfirdn2d_plain(_t(x), _t(k), 1, 1, pad)
    assert got.shape == ref.shape
    # f32: the same 12 products summed in another order
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("up,down,pad", [(1, 2, (1, 1, 1, 1)),
                                         (2, 1, (2, 1, 2, 1)),
                                         (2, 2, (1, 2, 0, 1)),
                                         (1, 1, (0, 0, 0, 0))])
def test_upfirdn2d_general_path_matches_jax(up, down, pad):
    x = np.random.default_rng(15).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    k = BLUR * (up ** 2)
    ref = jfir._upfirdn2d_xla(jnp.asarray(x), jnp.asarray(k), up, down, pad)
    got = upfirdn2d_plain(_t(x), _t(k), up, down, pad)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("pad", [(2, 2), (1, 1)])
def test_fir_gradient_matches_jax(interpret, pad):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jfir.upfirdn2d(a, jnp.asarray(BLUR),
                                                pad=pad, impl="pallas"),
                       jnp.asarray(x))
    g = rng.standard_normal(out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    leaf = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(
        upfirdn2d_plain(leaf, _t(BLUR), 1, 1, pad + pad), leaf, _t(g))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ---- B7: the fused bias + leaky ReLU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_act_plain_matches_jax_kernel(interpret, dtype):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((40, 128)).astype(np.float32)
    b = (0.3 * rng.standard_normal(128)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jfa._fused_pallas2d(jnp.asarray(x, jdt), jnp.asarray(b[None]),
                              jfa.SLOPE, jfa.SCALE)
    got = tfa.fused_act_plain(_t(x).to(getattr(torch, dtype)), _t(b))
    # the same roundings in the same order (bf16: t, slope * t and the
    # gain each round once)
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_act_custom_backward_matches_jax(interpret, dtype):
    rng = np.random.default_rng(18)
    x = rng.standard_normal((4, 6, 6, 64)).astype(np.float32)
    b = (0.3 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, vjp = jax.vjp(lambda a, c: jfa.fused_leaky_relu(a, c,
                                                         impl="pallas"),
                       jnp.asarray(x, jdt), jnp.asarray(b))
    dx_ref, db_ref = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    xs, bs = _t(x).to(tdt).requires_grad_(), _t(b).requires_grad_()
    y = tfa.FusedLeakyReLU.apply(xs, bs, tfa.SLOPE, tfa.SCALE)
    dx, db = torch.autograd.grad(y, (xs, bs), _t(g).to(tdt))
    np.testing.assert_array_equal(_np(y), np.asarray(out, np.float32))
    # dx: one product of the gain and g, rounded once on both sides
    np.testing.assert_array_equal(_np(dx), np.asarray(dx_ref, np.float32))
    # db: a sum over 144 rows in another order (bf16: of bf16 terms, and
    # rounded to bf16 before the cast to f32)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == "float32" else dict(
        atol=0.25, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(db), np.asarray(db_ref), **tol)


def test_force_plain_ops_counts_what_it_routes():
    tcommon.reset_launches()
    x = torch.zeros(2, 8)
    with tcommon.force_plain_ops():
        assert tcommon.use_kernel(x, op="fir") is False
    assert tcommon.PLAIN_CALLS["fir"] == 0  # CPU tensors are not routed
    assert tcommon._FORCE_PLAIN_DEPTH == 0


# -- the stage-2 GPT prior's ops ----------------------------------------------

# (shape (B, N, H, D), mask mode, cond_len, JAX reference): the Pallas
# packed kernel takes heads that fill 128-lane slabs, so (2, 40, 2, 32)
# is held against the XLA twin alone
BNHD_CASES = [((1, 33, 2, 384), "prefix_causal", 3, "pallas"),
              ((1, 33, 2, 384), "prefix_causal", 3, "xla"),
              ((2, 40, 4, 32), "prefix_causal", 2, "pallas"),
              ((2, 40, 2, 32), "none", 0, "xla"),
              ((2, 40, 2, 32), "prefix_causal", 1, "xla")]


@pytest.mark.parametrize("shape,mode,cl,ref", BNHD_CASES)
def test_attention_bnhd_plain_matches_jax(interpret, shape, mode, cl, ref):
    b, n, h, d = shape
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    # the JAX kernel and its twin take q already scaled in its dtype
    q3 = jnp.asarray(q * np.float32(d ** -0.5)).reshape(b, n, h * d)
    k3, v3 = (jnp.asarray(t).reshape(b, n, h * d) for t in (k, v))
    fn = (jatt._attention_packed_call if ref == "pallas"
          else jatt._attention_xla_packed)
    want = fn(q3, k3, v3, mode, cl, d)
    out = tatt.multihead_attention_bnhd(_t(q), _t(k), _t(v), mask_mode=mode,
                                        cond_len=cl)
    assert out.shape == shape
    # the tolerance of the JAX package's own packed attention test
    np.testing.assert_allclose(out.reshape(b, n, h * d).numpy(),
                               np.asarray(want), atol=3e-5, rtol=1e-4)


def _stale_stack(rng, layers, b, m, hd, cur):
    """(L, B, M, HD) k and v stacks whose rows past each row's cur_len
    hold 1e6: a version that read them would show it."""
    k = rng.standard_normal((layers, b, m, hd)).astype(np.float32)
    v = rng.standard_normal((layers, b, m, hd)).astype(np.float32)
    dead = np.arange(m)[None, :] >= np.reshape(cur, (-1, 1))
    k[:, np.broadcast_to(dead, (b, m))] = 1e6
    v[:, np.broadcast_to(dead, (b, m))] = 1e6
    return k, v


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("cur", [1, 5, 128, 200, 255, "ragged"])
@pytest.mark.parametrize("head_dim,hd", [(64, 256), (384, 768)])
def test_decode_attention_plain_matches_jax(interpret, ref, cur, head_dim,
                                            hd):
    layers, b, m, layer = 2, 3, 256, 1
    rng = np.random.default_rng(5)
    if cur == "ragged":
        cur = np.array([1, 128, 255], np.int32)
    k, v = _stale_stack(rng, layers, b, m, hd, cur)
    q3, kn, vn = (rng.standard_normal((b, hd)).astype(np.float32)
                  for _ in range(3))
    q3 *= np.float32(head_dim ** -0.5)
    cur_j = jnp.asarray(cur, jnp.int32)
    if ref == "pallas":
        want = jatt._decode_pallas(jnp.asarray(q3), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kn),
                                   jnp.asarray(vn), cur_j, head_dim,
                                   block_k=128, layer=jnp.int32(layer))
    else:
        want = jatt._decode_xla(jnp.asarray(q3), jnp.asarray(k[layer]),
                                jnp.asarray(v[layer]), jnp.asarray(kn),
                                jnp.asarray(vn), cur_j, head_dim)
    cur_t = cur if isinstance(cur, int) else _t(cur)
    out = tatt.decode_attention_stacked(_t(q3), _t(k), _t(v), _t(kn),
                                        _t(vn), cur_t, layer,
                                        head_dim=head_dim)
    assert out.shape == (b, hd)
    # the tolerance of the JAX package's own decode kernel test
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=2e-4)


def test_decode_attention_unstacked_matches_jax():
    rng = np.random.default_rng(6)
    k, v = _stale_stack(rng, 1, 2, 64, 128, 17)
    q3, kn, vn = (rng.standard_normal((2, 128)).astype(np.float32)
                  for _ in range(3))
    want = jatt.decode_attention(jnp.asarray(q3), jnp.asarray(k[0]),
                                 jnp.asarray(v[0]), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.int32(17), head_dim=64,
                                 impl="xla")
    out = tatt.decode_attention(_t(q3), _t(k[0]), _t(v[0]), _t(kn), _t(vn),
                                17, head_dim=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("cur", [0, 5, 15, "ragged"])
def test_cache_row_update_plain_matches_jax_kernel(interpret, cur):
    rng = np.random.default_rng(7)
    stack = rng.standard_normal((2, 3, 16, 128)).astype(np.float32)
    news = rng.standard_normal((2, 3, 1, 128)).astype(np.float32)
    if cur == "ragged":
        cur = np.array([0, 9, 15], np.int32)
    want = jcache._cache_row_update_pallas(jnp.asarray(stack),
                                           jnp.asarray(news),
                                           jnp.asarray(cur, jnp.int32))
    target = _t(stack.copy())
    out = tcache.cache_row_update(
        target, _t(news), cur if isinstance(cur, int) else _t(cur))
    assert out.data_ptr() == target.data_ptr()  # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_cache_row_update_rows_outside_the_cache_match_jax_xla():
    """A ragged row whose position lies outside [0, ctx) is left unwritten,
    as the JAX package's ragged path leaves it; a scalar outside raises."""
    rng = np.random.default_rng(8)
    stack = rng.standard_normal((2, 4, 16, 128)).astype(np.float32)
    news = rng.standard_normal((2, 4, 1, 128)).astype(np.float32)
    cur = np.array([-1, 16, 7, 40], np.int32)
    want = jcache.cache_row_update(jnp.asarray(stack), jnp.asarray(news),
                                   jnp.asarray(cur), impl="xla")
    out = tcache.cache_row_update(_t(stack.copy()), _t(news), _t(cur))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy()[:, [0, 1, 3]],
                                  stack[:, [0, 1, 3]])
    for bad in (-1, 16):
        with pytest.raises(IndexError):
            tcache.cache_row_update(_t(stack.copy()), _t(news), bad)


def test_decode_attention_rows_outside_the_cache_match_jax_xla():
    """Per-row lengths outside [0, M] clamp, as _decode_xla's mask reads
    them; a scalar outside raises."""
    rng = np.random.default_rng(9)
    cur = np.array([-3, 90, 17], np.int32)
    k, v = _stale_stack(rng, 1, 3, 64, 128, cur)
    q3, kn, vn = (rng.standard_normal((3, 128)).astype(np.float32)
                  for _ in range(3))
    want = jatt._decode_xla(jnp.asarray(q3), jnp.asarray(k[0]),
                            jnp.asarray(v[0]), jnp.asarray(kn),
                            jnp.asarray(vn), jnp.asarray(cur), 64)
    out = tatt.decode_attention(_t(q3), _t(k[0]), _t(v[0]), _t(kn), _t(vn),
                                _t(cur), head_dim=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    for bad in (-1, 65):
        with pytest.raises(ValueError):
            tatt.decode_attention(_t(q3), _t(k[0]), _t(v[0]), _t(kn),
                                  _t(vn), bad, head_dim=64)


def test_decode_attention_refuses_the_int8_cache():
    z = torch.zeros(2, 8, 64)
    with pytest.raises(NotImplementedError, match="A8"):
        tatt.decode_attention(z[:, 0], z, z, z[:, 0], z[:, 0], 3,
                              head_dim=32, k_scale=torch.ones(2, 8),
                              v_scale=torch.ones(2, 8))
