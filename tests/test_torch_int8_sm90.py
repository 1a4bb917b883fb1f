"""The arithmetic of the Hopper int8 decode MLP (``csrc/int8_mlp.cu`` on
``csrc/int8_wgmma.cuh``) and the host plans of it and of the streaming
LayerNorm (``csrc/layernorm.cu``), on the CPU.

The kernels run only on the card; what they compute is held here:

- the three bf16 pieces of an fp32 activation add up to it exactly, and
  every int8 x piece product is exact in fp32, so the tensor cores form the
  fp32 products of the JAX function;
- the K permutation that lets a thread read 4 consecutive weight bytes is
  the one the staged activations follow;
- a plain-torch mirror of the kernel's order of work (pieces, 128-wide k
  stages folded into fp32 sums, the hidden axis split as the plan splits
  it, partials summed in split order) against the JAX Pallas kernel
  ``_int8_mlp_pallas`` in interpret mode, within the f32 tolerance of
  ``tests/test_torch_int8.py``;
- ``ops.int8.int8_mlp_plan`` and ``ops.ln_gemm.layernorm_plan`` at the
  main path's shapes and the card tests' shapes, and what they refuse.
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

    def stages(a, w, k0, k1):
        total = torch.zeros(a.shape[0], w.shape[0])
        pieces = _pieces(a, n_pieces)
        for c in range(k0, k1, CHUNK):
            wc = w[:, c:c + CHUNK].float()
            parts = [p[:, c:c + CHUNK] @ wc.t() for p in pieces]
            t = parts[-1]
            for p in parts[-2::-1]:
                t = t + p
            total = total + t
        return total

    hid = stages(xn, w0_q, 0, xn.shape[1]) * s0
    if b0 is not None:
        hid = hid + b0.float()
    hid = tlg._act(hid, activation).to(dt).float()
    h = w1_q.shape[1]
    acc = None
    for sp in range(splits):
        k0 = sp * split_chunks * CHUNK
        part = stages(hid, w1_q, k0, min(k0 + split_chunks * CHUNK, h))
        acc = part if acc is None else acc + part
    res = residual.float() + (0.0 if b1 is None else b1.float())
    return (acc * s1 + res).to(dt)


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
