"""The arithmetic of the Hopper int8 decode kernels (the MLP
``csrc/int8_mlp.cu``, the GEMM ``csrc/int8_gemm.cu`` and the LN GEMM
``csrc/int8_ln_gemm.cu``, all on ``csrc/int8_wgmma.cuh``) and the host
plans of them and of the streaming LayerNorm (``csrc/layernorm.cu``), on
the CPU.

The kernels run only on the card; what they compute is held here:

- the three bf16 pieces of an fp32 activation add up to it exactly, and
  every int8 x piece product is exact in fp32, so the tensor cores form the
  fp32 products of the JAX function;
- the K permutation that lets a thread read 4 consecutive weight bytes is
  the one the staged activations follow;
- plain-torch mirrors of the kernels' order of work (pieces, 128-wide k
  stages folded into fp32 sums, the contraction split as the plan splits
  it, partials summed in split order; for the LN GEMM the fp32
  statistics, LN(x) rounded to x's dtype and the shift in x's dtype before
  the pieces) against the JAX Pallas kernels ``_int8_mlp_pallas``,
  ``_int8_gemm_pallas`` and ``_int8_ln_gemm_pallas`` in interpret mode,
  within the f32 tolerance of ``tests/test_torch_int8.py``;
- ``ops.int8.int8_mlp_plan``, ``ops.int8.int8_gemm_plan`` and
  ``ops.ln_gemm.layernorm_plan`` at the main path's shapes and the card
  tests' shapes, and what they refuse.
Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.ops import int8 as jint8
from enhancing_tpu_torch.ops import int8 as tint8
from enhancing_tpu_torch.ops import ln_gemm as tlg

# f32 with another summation order on each side (tests/test_torch_int8.py)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
# bf16: the hidden rounds to bf16 before W1 on both sides, so two bf16 steps
BF16_TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
CHUNK = 128  # k a stage of csrc/int8_mlp.cu


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _pieces(a: torch.Tensor, n: int) -> list:
    """int8_wgmma.cuh::split_pieces: each piece the bf16 nearest to what the
    earlier ones leave, the remainder an exact fp32 subtraction."""
    out, rest = [], a.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def _perm_col(k):
    """int8_wgmma.cuh::perm_col: physical j = 4q + 2h + e of a 16-wide k
    group is staged at column 8h + 2q + e."""
    j = k & 15
    return (k & ~15) | ((j & 2) << 2) | ((j >> 2) << 1) | (j & 1)


@pytest.mark.parametrize("lo,hi", [(-30, 30), (-100, -80), (100, 120)])
def test_three_bf16_pieces_are_exact(lo, hi):
    """hi + mid + lo == a for fp32 a whose pieces are normal numbers (|a|
    from 2^-100 to 2^120; LN(x) and the hidden lie far inside, or are 0),
    and every int8 x piece product is exact in fp32, so the products summed
    in exact arithmetic are the fp32 activation's exact products."""
    rng = np.random.default_rng(0)
    a = (rng.choice([-1.0, 1.0], 20000) * rng.uniform(1.0, 2.0, 20000)
         * np.exp2(rng.integers(lo, hi, 20000))).astype(np.float32)
    a[:5] = [1.0, -3.0000002, 2.0 ** -100, 65504.0, 0.0]
    t = torch.from_numpy(a)
    hi_, mid, lo_ = _pieces(t, 3)
    assert torch.equal((hi_ + mid) + lo_, t)
    assert torch.equal(hi_.to(torch.bfloat16).float(), hi_)
    assert torch.equal(lo_.to(torch.bfloat16).float(), lo_)
    w = torch.from_numpy(rng.integers(-127, 128, 20000).astype(np.float32))
    for p in (hi_, mid, lo_):
        assert torch.equal((w * p).double(), w.double() * p.double())
    exact = w.double() * t.double()
    assert torch.equal((w.double() * hi_.double() + w.double() * mid.double())
                       + w.double() * lo_.double(), exact)
    # summed in fp32, the pieces' products agree with the fp32 product to
    # its own rounding
    np.testing.assert_allclose(((w * lo_ + w * mid) + w * hi_).numpy(),
                               (w * t).numpy(), rtol=2.0 ** -22, atol=0)


def test_k_permutation_matches_the_fragment_bytes():
    """The 4 bytes a thread of fragment column pair q reads per k16 slice
    (physical 4q .. 4q + 3) are the A fragment's columns 2q, 2q + 1, 2q + 8,
    2q + 9, and the activations staged at those columns are the ones those
    weights multiply; perm_col is a permutation of each 16-wide group."""
    for base in (0, 16, 6128):
        cols = [_perm_col(base + j) for j in range(16)]
        assert sorted(cols) == list(range(base, base + 16))
    for q in range(4):
        got = [_perm_col(4 * q + i) for i in range(4)]
        assert got == [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]


def _b14_mirror(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, residual,
                activation, eps, splits, split_chunks):
    """The kernel's order of work in plain torch: LN(x) and the hidden
    rounded to x's dtype and cut into pieces (3 for fp32 x, 1 for bf16);
    each 128-wide k stage a fresh fp32 sum of its piece products, the
    pieces added smallest first, then added into the running sum; phase C's
    hidden axis in ``splits`` ranges of ``split_chunks`` stages, the
    partials summed in split order. Weights (n, k) int8."""
    dt = x.dtype
    n_pieces = 3 if dt == torch.float32 else 1
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    xn = ((x32 - mean) * (1.0 / torch.sqrt(var + eps) * gamma) + beta
          ).to(dt).float()

    hid = _stage_sums(_pieces(xn, n_pieces), w0_q, 0, xn.shape[1]) * s0
    if b0 is not None:
        hid = hid + b0.float()
    hid = tlg._act(hid, activation).to(dt).float()
    acc = _split_sums(_pieces(hid, n_pieces), w1_q, splits, split_chunks)
    res = residual.float() + (0.0 if b1 is None else b1.float())
    return (acc * s1 + res).to(dt)


def _stage_sums(pieces, w, k0, k1):
    """Sum over k in [k0, k1) of the pieces' products with the (n, k) int8
    weight: each 128-wide k stage a fresh fp32 sum, its pieces added
    smallest first, then added into the running sum."""
    total = torch.zeros(pieces[0].shape[0], w.shape[0])
    for c in range(k0, k1, CHUNK):
        wc = w[:, c:c + CHUNK].float()
        parts = [p[:, c:c + CHUNK] @ wc.t() for p in pieces]
        t = parts[-1]
        for p in parts[-2::-1]:
            t = t + p
        total = total + t
    return total


def _split_sums(pieces, w, splits, split_chunks):
    """The contraction in ``splits`` ranges of ``split_chunks`` stages, the
    partials summed in split order (from zero) as the last split to finish
    sums them; one split is the running sum itself."""
    k = w.shape[1]
    if splits == 1:
        return _stage_sums(pieces, w, 0, k)
    acc = torch.zeros(pieces[0].shape[0], w.shape[0])
    for sp in range(splits):
        k0 = sp * split_chunks * CHUNK
        acc = acc + _stage_sums(pieces, w, k0,
                                min(k0 + split_chunks * CHUNK, k))
    return acc


def _weight(rng, d, n):
    """A JAX (d, n) kernel quantised by the JAX package: (w_q, scale)."""
    w = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    w_q, scale = jint8.quantize_channelwise(jnp.asarray(w))
    return np.asarray(w_q), np.asarray(scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_b14_piecewise_mirror_matches_jax_kernel(interpret, dtype, bias):
    """The kernel's arithmetic, mirrored in torch with the plan's splits
    (4 at d 128, h 512), against the Pallas kernel in interpret mode on the
    shapes that pass its gates (m 8, d % 128, h % 512)."""
    m, d, h = 8, 128, 512
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w0_q, s0 = _weight(rng, d, h)
    w1_q, s1 = _weight(rng, h, d)
    b0 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jint8._int8_mlp_pallas(
        xj, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w0_q),
        jnp.asarray(s0), jnp.asarray(b0 if bias else np.zeros(h, np.float32)),
        jnp.asarray(w1_q), jnp.asarray(s1), jnp.asarray(b1) if bias else None,
        xj, "sqrelu", 1e-5)
    plan = tint8.int8_mlp_plan(m, d, h, pieces=3 if dtype == "float32" else 1)
    assert plan["splits"] == 4
    t = torch.from_numpy
    got = _b14_mirror(xt, t(gamma), t(beta), t(w0_q.T.copy()), t(s0),
                      t(b0) if bias else None, t(w1_q.T.copy()), t(s1),
                      t(b1) if bias else None, xt, "sqrelu", 1e-5,
                      plan["splits"], plan["split_chunks"])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("m,d,h", [(3, 256, 1024), (19, 512, 2048),
                                   (9, 256, 1040)])
def test_b14_piecewise_mirror_matches_plain(m, d, h):
    """At the card tests' shapes (and h not a multiple of the 64-channel
    tile), fp32 x, the mirror with the plan's splits against the port's
    plain version, which takes fp32 products in one sum."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    gamma = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(d)).float()
    beta = torch.from_numpy(0.1 * rng.standard_normal(d)).float()
    w0 = torch.from_numpy(rng.standard_normal((h, d)) * 0.02).float()
    w1 = torch.from_numpy(rng.standard_normal((d, h)) * 0.02).float()
    (w0_q, s0), (w1_q, s1) = (tint8.quantize_channelwise(w) for w in (w0, w1))
    b0 = torch.from_numpy(0.1 * rng.standard_normal(h)).float()
    b1 = torch.from_numpy(0.1 * rng.standard_normal(d)).float()
    plan = tint8.int8_mlp_plan(m, d, h)
    got = _b14_mirror(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, x,
                      "sqrelu", 1e-5, plan["splits"], plan["split_chunks"])
    want = tint8.int8_mlp_plain(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1,
                                x)
    top = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * top,
                               rtol=1e-5)


def _b12_mirror(x, w_q, scale, b, residual, activation, splits,
                split_chunks):
    """csrc/int8_gemm.cu's order of work in plain torch: x cut into pieces
    (3 for fp32 x, 1 for bf16), the 128-wide stages of each split folded,
    the splits' partials summed in split order, then scale, bias, the
    activation and the residual in fp32 and one rounding to x's dtype.
    Weight (n, d) int8."""
    dt = x.dtype
    acc = _split_sums(_pieces(x.float(), 3 if dt == torch.float32 else 1),
                      w_q, splits, split_chunks)
    out = acc * scale
    if b is not None:
        out = out + b.float()
    out = tlg._act(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(dt)


def _b13_mirror(x, gamma, beta, tm, prev, w_q, scale, b, activation, eps,
                splits, split_chunks):
    """csrc/int8_ln_gemm.cu's order of work in plain torch: fp32 row
    statistics with the fast variance; LN(x) rounded to x's dtype; with tm
    the shift LN(x) * tm + prev * (1 - tm), each step in x's dtype; then
    the pieces of that and B12's products and epilogue (no residual).
    Returns (y, LN(x))."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    xn = ((x32 - mean) * (1.0 / torch.sqrt(var + eps) * gamma) + beta).to(dt)
    mixed = xn
    if tm is not None:
        t = tm.to(dt)
        mixed = xn * t + prev.to(dt) * (1.0 - t)
    return _b12_mirror(mixed, w_q, scale, b, None, activation, splits,
                       split_chunks), xn


def _jx(a, dtype):
    """(JAX array in the JAX dtype, torch tensor of the same values)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(a, jdt)
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,bias,residual,activation", [
    (8, True, True, "gelu"), (8, False, False, None),
    (16, True, False, "sqrelu")])
def test_b12_piecewise_mirror_matches_jax_kernel(interpret, dtype, m, bias,
                                                 residual, activation):
    """B12's arithmetic, mirrored in torch with the plan's splits (4 at d
    512, n 256), against ``_int8_gemm_pallas`` in interpret mode on shapes
    that pass its gates (d, n % 128), with the bias, the residual and the
    activation on and off; 16 rows are two row tiles."""
    d, n = 512, 256
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.5).astype(np.float32)
    w_q, scale = _weight(rng, d, n)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    xj, xt = _jx(x, dtype)
    want = jint8._int8_gemm_pallas(
        xj, jnp.asarray(w_q), jnp.asarray(scale),
        jnp.asarray(b if bias else np.zeros(n, np.float32)),
        jnp.asarray(res) if residual else None, activation)
    plan = tint8.int8_gemm_plan(m, d, n,
                                pieces=3 if dtype == "float32" else 1)
    assert plan["splits"] == 4
    t = torch.from_numpy
    got = _b12_mirror(xt, t(w_q.T.copy()), t(scale), t(b) if bias else None,
                      t(res) if residual else None, activation,
                      plan["splits"], plan["split_chunks"])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,shift,bias,activation", [
    (8, True, True, None), (8, False, False, None),
    (16, True, False, "gelu")])
def test_b13_piecewise_mirror_matches_jax_kernel(interpret, dtype, m, shift,
                                                 bias, activation):
    """B13's arithmetic (statistics, LN(x) rounded, the shift, then the
    pieces), mirrored in torch with the plan's splits, against
    ``_int8_ln_gemm_pallas`` in interpret mode, the shift and the bias on
    and off; LN(x) compared too."""
    d, n = 512, 256
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    tm = rng.uniform(0.0, 1.0, d).astype(np.float32)
    prev = rng.standard_normal((m, d)).astype(np.float32)
    w_q, scale = _weight(rng, d, n)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    xj, xt = _jx(x, dtype)
    pj, pt = _jx(prev, dtype)
    out, xn = jint8._int8_ln_gemm_pallas(
        xj, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(tm), pj,
        jnp.asarray(w_q), jnp.asarray(scale),
        jnp.asarray(b if bias else np.zeros(n, np.float32)), activation,
        1e-5, shift)
    plan = tint8.int8_gemm_plan(m, d, n,
                                pieces=3 if dtype == "float32" else 1)
    t = torch.from_numpy
    got, got_xn = _b13_mirror(
        xt, t(gamma), t(beta), t(tm) if shift else None,
        pt if shift else None, t(w_q.T.copy()), t(scale),
        t(b) if bias else None, activation, 1e-5, plan["splits"],
        plan["split_chunks"])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(out, np.float32), **tol)
    np.testing.assert_allclose(got_xn.float().numpy(),
                               np.asarray(xn, np.float32), **tol)


@pytest.mark.parametrize("m,d,n", [(5, 1040, 136), (13, 512, 1000),
                                   (40, 256, 200)])
def test_b12_b13_piecewise_mirrors_match_plain(m, d, n):
    """At the card tests' kinds of shape (ragged m, d not a multiple of the
    128-wide stage, n not a multiple of 192), fp32 x, the mirrors with the
    plan's splits against the port's plain versions, which take fp32
    products in one sum."""
    rng = np.random.default_rng(17)
    t = torch.from_numpy
    x = t(rng.standard_normal((m, d)).astype(np.float32))
    gamma = t(1.0 + 0.1 * rng.standard_normal(d)).float()
    beta = t(0.1 * rng.standard_normal(d)).float()
    tm = t(rng.uniform(0.0, 1.0, d)).float()
    prev = t(rng.standard_normal((m, d))).bfloat16()
    w_q, scale = tint8.quantize_channelwise(
        t(rng.standard_normal((n, d)) * 0.02).float())
    b = t(0.1 * rng.standard_normal(n)).float()
    res = t(rng.standard_normal((m, n))).float()
    plan = tint8.int8_gemm_plan(m, d, n)
    got = _b12_mirror(x, w_q, scale, b, res, "gelu", plan["splits"],
                      plan["split_chunks"])
    want = tint8.int8_gemm_plain(x, w_q, scale, b, res, "gelu")
    top = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * top,
                               rtol=1e-5)
    got, got_xn = _b13_mirror(x, gamma, beta, tm, prev, w_q, scale, b,
                              "sqrelu", 1e-5, plan["splits"],
                              plan["split_chunks"])
    want, want_xn = tint8.int8_ln_gemm_plain(x, gamma, beta, tm, prev, w_q,
                                             scale, b, "sqrelu")
    top = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * top,
                               rtol=1e-5)
    np.testing.assert_allclose(got_xn.numpy(), want_xn.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_int8_gemm_plan_at_the_prior_shapes():
    """The int8 decode step's four products at the prior's widths (batch
    8) on a 132-SM card: the projection (fp32 x, 6144 -> 6144) 32 groups x
    4 splits of 12 stages, 128 blocks; the prefill's bf16 qkv and the
    decode qkv (-> 18432) 96 groups x 4 splits, 132 blocks (33 a split,
    at most 3 units each); the vocab head (-> 8192) 43 groups x 3 splits of
    16 stages, 129 blocks."""
    res3, res1, stage = 2 * 8 * 3 * 128, 2 * 8 * 128, 3 * 64 * 128
    slots = 3 * 2 * 8 * 64 * 4  # the epilogue warps' slots
    assert tint8.int8_gemm_plan(8, 6144, 6144, 132, 3) == dict(
        grid=128, row_tiles=1, groups=32, splits=4, split_chunks=12,
        stages=4, smem=12 * res3 + 4 * stage + slots + 1024,
        part_bytes=4 * 4 * 8 * 6144, sync_words=96)
    for pieces, res, stages in ((1, res1, 4), (3, res3, 4)):
        assert tint8.int8_gemm_plan(8, 6144, 18432, 132, pieces) == dict(
            grid=132, row_tiles=1, groups=96, splits=4, split_chunks=12,
            stages=stages, smem=12 * res + stages * stage + slots + 1024,
            part_bytes=4 * 4 * 8 * 18432, sync_words=288)
    assert tint8.int8_gemm_plan(8, 6144, 8192, 132, 3) == dict(
        grid=129, row_tiles=1, groups=43, splits=3, split_chunks=16,
        stages=4, smem=16 * res3 + 4 * stage + slots + 1024,
        part_bytes=4 * 3 * 8 * 8192, sync_words=128)


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_int8_gemm_plan_at_the_card_test_shapes(sms):
    """Every shape of the card tests, both piece counts: no split empty,
    the splits' chunks cover K, the resident pieces and the ring fit a
    block, one block an SM at most, partials and counts only when split."""
    for m, d, n in ((8, 6144, 6144), (8, 6144, 18432), (8, 6144, 8192),
                    (1, 6144, 1000), (5, 6144, 1000), (13, 6144, 1000),
                    (40, 6144, 1000), (3, 256, 200), (20, 1040, 96),
                    (5, 512, 136), (8, 16, 8), (1100, 256, 200)):
        for pieces in (1, 3):
            p = tint8.int8_gemm_plan(m, d, n, sms, pieces)
            chunks, tiles = -(-d // CHUNK), -(-n // 64)
            assert p["row_tiles"] == -(-m // 8)
            assert p["groups"] == -(-tiles // 3)
            assert p["splits"] * p["split_chunks"] >= chunks
            assert (p["splits"] - 1) * p["split_chunks"] < chunks
            units = p["row_tiles"] * p["groups"] * p["splits"]
            assert p["grid"] == min(sms, units)
            # every unit has a block, and no block more than its share
            # when blocks take one stream each
            busiest = tint8._max_units(p["groups"], p["row_tiles"]
                                       * p["splits"], p["grid"])
            assert busiest * p["grid"] >= units
            if m == 1100:  # more streams than blocks: units cross streams
                assert p["row_tiles"] * p["splits"] > p["grid"]
            assert 2 <= p["stages"] <= 4 and p["smem"] <= 232448 - 1024
            split = p["splits"] > 1
            assert p["part_bytes"] == (4 * p["row_tiles"] * p["splits"] * 8
                                       * n if split else 0)
            assert p["sync_words"] == (p["row_tiles"] * tiles if split
                                       else 0)


@pytest.mark.parametrize("m,d,n,pieces", [(0, 256, 1024, 3),
                                          (8, 200, 1024, 3),
                                          (8, 256, 0, 1), (8, 256, 1024, 2),
                                          (8, -16, 1024, 1)])
def test_int8_gemm_plan_refuses_what_the_kernel_refuses(m, d, n, pieces):
    with pytest.raises(ValueError):
        tint8.int8_gemm_plan(m, d, n, 132, pieces)


def _check_mlp_plan(p, d, h, sms):
    chunks_c = -(-h // CHUNK)
    assert 1 <= p["grid"] <= sms
    assert p["groups_b"] == -(-(-(-h // 64)) // 3)
    assert p["splits"] * p["split_chunks"] >= chunks_c
    assert (p["splits"] - 1) * p["split_chunks"] < chunks_c  # none empty
    assert p["groups_c"] == -(-(-(-d // 64)) // 3) * p["splits"]
    assert p["grid"] == min(sms, max(p["groups_b"], p["groups_c"]))
    assert 2 <= p["stages"] <= 6 and p["smem"] <= 232448
    assert p["sync_words"] == 2 + -(-d // 64)


def test_int8_mlp_plan_at_the_prior_and_the_card_test_shapes():
    """The published prior's decode MLP (8, 6144, 24576): 128 blocks of 3
    hidden tiles in phase B, 96 output tiles x 4 splits of 48 stages in
    phase C; and every shape of tests/test_torch_cuda.py's int8 MLP tests,
    both piece counts, on a 132-SM card and a smaller one."""
    p = tint8.int8_mlp_plan(8, 6144, 24576, 132)
    assert p == dict(grid=128, groups_b=128, groups_c=128, splits=4,
                     split_chunks=48, stages=6, smem=6 * 30720 + 1024,
                     ws_bytes=2 * 8 * 3 * (6144 + 24576) + 4 * 4 * 8 * 6144,
                     sync_words=98)
    p1 = tint8.int8_mlp_plan(8, 6144, 24576, 132, pieces=1)
    assert (p1["stages"], p1["smem"], p1["ws_bytes"]) == (
        6, 6 * 26624 + 1024, 2 * 8 * (6144 + 24576) + 4 * 4 * 8 * 6144)
    for m, d, h in ((8, 6144, 24576), (3, 256, 1024), (19, 512, 2048),
                    (1, 256, 1040), (17, 6144, 24576), (9, 16, 16)):
        for sms in (132, 114, 1):
            for pieces in (1, 3):
                _check_mlp_plan(tint8.int8_mlp_plan(m, d, h, sms, pieces),
                                d, h, sms)


@pytest.mark.parametrize("m,d,h,pieces", [(0, 256, 1024, 3), (8, 200, 1024, 3),
                                          (8, 256, 1000, 3), (8, 256, 1024, 2),
                                          (8, -16, 1024, 1)])
def test_int8_mlp_plan_refuses_what_the_kernel_refuses(m, d, h, pieces):
    with pytest.raises(ValueError):
        tint8.int8_mlp_plan(m, d, h, 132, pieces)


def test_layernorm_plan_at_the_main_path_and_ragged_shapes():
    """The tokenizer's final LayerNorm at batch 128 (131072 x 768 bf16):
    8-row tiles of 12 KB, a 4-stage ring, three blocks an SM; fp32 rows of
    2048 fit one block an SM; narrow rows take more rows a tile; a grid
    never exceeds the tiles."""
    p = tlg.layernorm_plan(131072, 768, 2, 132)
    assert p == dict(rows=8, stages=4, smem=4 * 8 * 1536 + 2 * 768 * 4,
                     grid=396)
    assert tlg.layernorm_plan(1, 768, 2, 132)["grid"] == 1
    assert tlg.layernorm_plan(9, 768, 4, 132)["grid"] == 2
    p = tlg.layernorm_plan(4096, 2048, 4, 132)
    assert (p["rows"], p["stages"], p["grid"]) == (8, 2, 132)
    assert p["smem"] == 2 * 8 * 8192 + 2 * 2048 * 4
    p = tlg.layernorm_plan(5, 64, 2, 132)
    assert (p["rows"], p["grid"]) == (64, 1)
    for m in (1, 7, 8, 9, 263, 264, 265, 131073):
        for d, item in ((768, 2), (768, 4), (64, 2), (2048, 2), (8, 2)):
            p = tlg.layernorm_plan(m, d, item, 132)
            assert 1 <= p["grid"] <= min(-(-m // p["rows"]), 396)
            assert p["smem"] <= 232448 and 2 <= p["stages"] <= 4


@pytest.mark.parametrize("m,d,itemsize", [(0, 768, 2), (8, 772, 2),
                                          (8, 2056, 4), (8, 770, 4),
                                          (8, 768, 1)])
def test_layernorm_plan_refuses_what_the_kernel_refuses(m, d, itemsize):
    with pytest.raises(ValueError):
        tlg.layernorm_plan(m, d, itemsize, 132)
