"""The arithmetic of the fp32 attention kernels on exact bf16 pieces, on
the CPU.

``csrc/attention_f32.cu`` computes every fp32 product of the attention
forward (B2, B8, B17-B19) and backward (B5) on the bf16 tensor cores: each
fp32 operand is split into three bf16 pieces whose sum is the value
exactly, and a product is the six cross terms hi*hi, hi*mid, mid*hi,
hi*lo, lo*hi and mid*mid, hi*hi in one fp32 accumulator and the small
five in another, folded last (``sm90.cuh``, "exact products"). Here that
arithmetic is written out in fp32: the piece product against an fp64
product, and the kernels' orders of work (64-key tiles and the online
softmax forward; the rows kernel's one-sweep statistics and the cols
kernel's 32-query tiles backward) against the JAX kernels run in
interpret mode, and the fp32 fusions' (``attn_proj_f32.cu``,
``ffn_f32.cu``: heads projected by piece products over all of H*D; the
FFN's hidden) against their plain versions. Also here: the fp32 fusions'
plans, the routes of the two opt-in fusions against the JAX package's own
dispatch, and their unfused forms against the JAX functions they compute
(``_attention_proj_xla``, ``_ffn_xla``). Inputs are made with numpy from
a seed.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.ops import ffn as jffn
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.ops import ffn as tffn
from enhancing_tpu_torch.ops.ln_gemm import _act

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's phase 3 limits: fp32 sums in another order
F32_TOL = dict(atol=1e-4, rtol=1e-5)
F32_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
KEYS, COLS = 64, 32  # keys a tile; queries a tile of the cols kernel
# the small cross terms (A piece, B piece): 0 hi, 1 mid, 2 lo
SMALL = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def pieces(x):
    """hi, mid, lo: each exactly a bf16, their sum x (fp32)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def piece_matmul(a, b):
    """a @ b as the kernels form it: hi*hi in one fp32 sum, the five small
    terms in another, added last (every piece product exact in fp32)."""
    pa, pb = pieces(a.float()), pieces(b.float())
    big = pa[0] @ pb[0]
    small = torch.zeros_like(big)
    for i, j in SMALL:
        small = small + pa[i] @ pb[j]
    return small + big


def _cxx_terms():
    """sm90.cuh's small_a and small_b, evaluated for i = 0..4."""
    src = (ROOT / "enhancing_tpu_torch/csrc/sm90.cuh").read_text()
    out = []
    for name in ("small_a", "small_b"):
        body = re.search(name + r"\(int i\) \{\s*return ([^;]+);", src)[1]
        parts = [p.strip() for p in re.split(r"[?:]", body)]
        vals = []
        for i in range(5):
            conds, rest = parts[0::2][:-1], parts[1::2] + [parts[-1]]
            for cond, val in zip(conds, rest):
                if eval(cond.replace("||", " or "), {"i": i}):
                    vals.append(int(val))
                    break
            else:
                vals.append(int(parts[-1]))
        out.append(vals)
    return tuple(zip(*out))


def test_small_terms_are_the_kernels():
    """The mirror's five small terms are the ones sm90.cuh issues."""
    assert _cxx_terms() == SMALL


@pytest.mark.parametrize("exp", [-30, -6, 0, 4, 40])
@pytest.mark.parametrize("k", [16, 64, 384])
def test_piece_product_matches_fp64(exp, k):
    """Against the fp64 product: the three dropped terms (mid*lo, lo*mid,
    lo*lo) and the residual of the third piece are ~3 x 2^-24 of each
    |a_i b_i|, and each fp32 sum (the six terms' and the fold) adds at most
    an ulp of its running |sum| a term: bounded by (k + 8) 2^-24
    sum_i |a_i b_i|, at operands 2^exp in size and rows of B scaled by
    2^-4 ... 2^4."""
    rng = np.random.default_rng(k * 100 + exp + 50)
    a = (rng.standard_normal((64, k)) * 2.0 ** exp).astype(np.float32)
    b = (rng.standard_normal((k, 48)) *
         2.0 ** rng.integers(-4, 5, (k, 1))).astype(np.float32)
    got = piece_matmul(torch.from_numpy(a), torch.from_numpy(b)).double()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    want = a64 @ b64
    mag = np.abs(a64) @ np.abs(b64)
    assert np.all(np.abs(got.numpy() - want) <= (k + 8) * 2.0 ** -24 * mag)


# -- the forward: 64-key tiles, online softmax, piece products ---------------

def fwd_mirror(q, k, v, mask_mode, cond_len, scale=1.0, score_scale=False):
    """attn_f32_fwd_kernel's and attn_f32_wide_kernel's arithmetic on
    (B, H, N, D) q (scaled in fp32 unless ``score_scale``) and (B, H, M,
    D) k, v: S by piece products, the row max of the raw scores, e^(c (s
    - m)) with c the scale on the scores (else 1), O and l rescaled per
    64-key tile, O += P V by piece products, one 1 / l at the end."""
    n, m = q.shape[-2], k.shape[-2]
    s = piece_matmul(q, k.transpose(-1, -2))
    if mask_mode == "prefix_causal":
        rows = torch.arange(n)[:, None]
        cols = torch.arange(m)[None, :]
        s = torch.where((cols <= rows) | ((rows < cond_len) &
                                          (cols < cond_len)), s, -torch.inf)
    c = scale if score_scale else 1.0
    run = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for t0 in range(0, m, KEYS):
        st = s[..., t0:t0 + KEYS]
        m_new = torch.maximum(run, st.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(c * (run - m_use))
        p = torch.exp(c * (st - m_use[..., None]))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + piece_matmul(p, v[..., t0:t0 + KEYS, :])
        run = m_new
    return o * (1.0 / l)[..., None]


def _bnhd(rng, b, n, h, d):
    return [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for _ in range(3)]


def _t(a):  # numpy (B, N, H, D) -> torch (B, H, N, D)
    return torch.from_numpy(a).transpose(1, 2)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
def test_forward_mirror_d64_matches_jax_packed_qkv(interpret, mode, cl):
    """B2 at D = 64: the mirror on the qkv buffer's q (scaled in fp32), k,
    v against ``_attention_packed_qkv_call`` and the plain version."""
    b, n, h, d = 2, 130, 2, 64
    rng = np.random.default_rng(64)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    scale = d ** -0.5
    q3, k3, v3 = tatt.split_qkv_scaled(torch.from_numpy(qkv), scale)
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (q3, k3, v3))
    got = fwd_mirror(q, k, v, mode, cl).transpose(1, 2).reshape(b, n, h * d)
    want = np.asarray(jatt._attention_packed_qkv_call(
        jnp.asarray(qkv), mode, cl, d, scale))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    plain = tatt.attention_packed_qkv_plain(torch.from_numpy(qkv), h, d,
                                            scale, mode, cl)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("d", [80, 384])
def test_forward_mirror_matches_jax_bnhd(interpret, d, mode, cl):
    """B8 at D = 80 (the kernel's 128 tile: q, k, v zero-padded, the lanes
    past 80 dropped) and at the prior's 384 (attn_f32_wide_kernel): the
    mirror against ``multihead_attention_bnhd`` in interpret mode (which
    pads 80 to 128 itself) and the plain version."""
    b, n, h = 2, 70, 2
    q, k, v = _bnhd(np.random.default_rng(d), b, n, h, d)
    scale = d ** -0.5
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    tile = 128 if d == 80 else d
    pad = [torch.nn.functional.pad(t, (0, tile - d)).transpose(1, 2)
           for t in (qt * torch.tensor(scale), kt, vt)]
    got = fwd_mirror(*pad, mode, cl)[..., :d].transpose(1, 2)
    want = np.asarray(jatt.multihead_attention_bnhd(
        *(jnp.asarray(a) for a in (q, k, v)), scale=scale, mask_mode=mode,
        cond_len=cl, impl="pallas"))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    plain = tatt.attention_bnhd_plain(qt, kt, vt, scale, mode, cl)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)


@pytest.mark.parametrize("n,m", [(65, 130), (130, 65)])
def test_forward_mirror_score_scale(n, m):
    """B17 / B18: the scale on the fp32 scores (the row max of the raw
    scores, the scale in the exponent), M != N, against the plain
    version."""
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.standard_normal((2, 2, n, 64)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, m, 64)).astype(
        np.float32)) for _ in range(2))
    scale = 64 ** -0.5
    got = fwd_mirror(q, k, v, "prefix_causal", 3, scale, score_scale=True)
    want = tatt.attention_plain(q, k, v, scale, "prefix_causal", 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


# -- the backward: one-sweep statistics, 32-query cols tiles ---------------

def piece_matmul_acc(acc, a, b):
    """acc + a @ b as the backward kernels' accumulate products add it: the
    five small terms, then hi*hi, into the running fp32 sum (every piece
    product exact in fp32)."""
    pa, pb = pieces(a.float()), pieces(b.float())
    for i, j in SMALL:
        acc = acc + pa[i] @ pb[j]
    return acc + pa[0] @ pb[0]


def bwd_mirror(q, k, v, do, mask_mode, cond_len, wide=False):
    """attn_f32_bwd_rows_kernel / _cols_kernel's arithmetic on (B, H, N, D)
    q (already scaled), k, v and dO: S and dP by piece products; m, 1 / l
    and delta from one online sweep over 64-key tiles; P and dS in fp32;
    dq = dS K by piece products; dk and dv summed over 32-query tiles of
    dS^T q and P^T dO by piece products.

    ``wide``: csrc/attention_bwd_wide.cu's (D = 384) instead: the same
    statistics sweep (its rows kernel's sweep 1); dq summed over the 64-key
    tiles of dS K (sweep 2), dk and dv over the 64-query tiles of dS^T q and
    P^T dO (its dk and dv blocks), each tile's six piece products added to
    the running accumulator. bf16 operands (wide): the products exact in
    fp32 (one piece each), dS rounded to bf16 before the dq and dk products
    and P before the dv product, the outputs rounded once."""
    bf16 = q.dtype == torch.bfloat16
    q, k, v, do = (t.float() for t in (q, k, v, do))
    n = q.shape[-2]
    s = piece_matmul(q, k.transpose(-1, -2))
    dp = piece_matmul(do, v.transpose(-1, -2))
    if mask_mode == "prefix_causal":
        rows = torch.arange(n)[:, None]
        cols = torch.arange(n)[None, :]
        s = torch.where((cols <= rows) | ((rows < cond_len) &
                                          (cols < cond_len)), s, -torch.inf)
    run = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    g = torch.zeros(s.shape[:-1])
    for t0 in range(0, n, KEYS):
        st, dpt = s[..., t0:t0 + KEYS], dp[..., t0:t0 + KEYS]
        m_new = torch.maximum(run, st.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp(run - m_use)
        e = torch.exp(st - m_use[..., None])
        l = l * alpha + e.sum(-1)
        g = g * alpha + (e * dpt).sum(-1)
        run = m_new
    inv = 1.0 / l
    p = torch.exp(s - run[..., None]) * inv[..., None]
    ds = p * (dp - (g * inv)[..., None])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    if not wide:
        dq = piece_matmul(ds, k)
        for i0 in range(0, n, COLS):
            dk = dk + piece_matmul(ds[..., i0:i0 + COLS, :].transpose(-1, -2),
                                   q[..., i0:i0 + COLS, :])
            dv = dv + piece_matmul(p[..., i0:i0 + COLS, :].transpose(-1, -2),
                                   do[..., i0:i0 + COLS, :])
        return dq, dk, dv
    if bf16:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.zeros_like(q)
    for t0 in range(0, n, KEYS):
        dq = piece_matmul_acc(dq, ds[..., t0:t0 + KEYS], k[..., t0:t0 + KEYS, :])
        dk = piece_matmul_acc(dk, ds[..., t0:t0 + KEYS, :].transpose(-1, -2),
                              q[..., t0:t0 + KEYS, :])
        dv = piece_matmul_acc(dv, p[..., t0:t0 + KEYS, :].transpose(-1, -2),
                              do[..., t0:t0 + KEYS, :])
    out = (dq, dk, dv)
    return tuple(t.to(torch.bfloat16) for t in out) if bf16 else out


# bf16 at D = 384 against the JAX kernel: both round P and dS to bf16 from
# fp32 values whose sums run in other orders, so a few round to the
# neighbouring bf16 (a 2^-8 relative step of one term of a sum), and both
# round the outputs once (half a bf16 step each): 2^-7 of the largest
# |ref| plus 2^-7 relative element by element, and ||mirror - ref|| within
# 2^-10 of ||ref|| (measured 1.9e-4; a mirror that rounds neither P nor dS
# is 2.6e-3 off, which only this limit sees). Against the plain version in
# fp32 on the same bf16 inputs, chip_smoke.py phase 3's bf16 limit for B5
# (2^-6 of the largest |plain| + 2^-6 relative): P and dS rounded to bf16
# before sums of up to N terms, and the outputs rounded.
BF16_JAX_TOL, BF16_JAX_NORM, BF16_PLAIN_TOL = 2.0 ** -7, 2.0 ** -10, 2.0 ** -6


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 5)])
@pytest.mark.parametrize("d,dtype", [
    pytest.param(64, torch.float32, id="64"),
    pytest.param(80, torch.float32, id="80"),
    pytest.param(384, torch.float32, id="384"),
    pytest.param(384, torch.bfloat16, id="384-bf16")])
def test_backward_mirror_matches_jax_and_plain(interpret, d, dtype, mode, cl):
    """B5: the mirror against ``_attention_packed_bwd_call`` in interpret
    mode (at D = 80 on heads zero-padded to 128 lanes, as JAX's
    ``multihead_attention_bnhd`` runs that head dim, and as the kernel's
    128 tile reads it; at D = 384 on a slab of 384 lanes, no padding, in
    the inputs' dtype) and against autograd of the plain version (in
    fp32, on the same bf16 values at D = 384 in bf16). N = 100 leaves a
    ragged tile."""
    b, n, h = 2, 100, 2
    rng = np.random.default_rng(d + 1 + (dtype == torch.bfloat16))
    q, k, v = _bnhd(rng, b, n, h, d)
    q = q * np.float32(d ** -0.5)
    do = rng.standard_normal((b, n, h, d)).astype(np.float32)
    if dtype == torch.bfloat16:  # the operands as the kernel gets them
        q, k, v, do = (torch.from_numpy(a).to(dtype).float().numpy()
                       for a in (q, k, v, do))
    got = bwd_mirror(*(_t(a).to(dtype) for a in (q, k, v, do)), mode, cl,
                     wide=d == tatt.WIDE_HEAD_DIM)
    tile = 128 if d == 80 else d
    padded = [np.pad(a, ((0, 0), (0, 0), (0, 0), (0, tile - d))).reshape(
        b, n, h * tile) for a in (q, k, v, do)]
    ref = jatt._attention_packed_bwd_call(
        *(jnp.asarray(a, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32) for a in padded), mode, cl, tile)
    plain = tatt.attention_bwd_plain(
        *(torch.from_numpy(a).reshape(b, n, h * d) for a in (q, k, v, do)),
        h, d, mode, cl)
    for name, g_, r, p in zip("qkv", got, ref, plain):
        g3 = g_.float().transpose(1, 2).numpy()
        r3 = np.asarray(r, dtype=np.float32).reshape(b, n, h, tile)[..., :d]
        p3 = p.numpy()
        if dtype == torch.float32:
            jax_tol = plain_tol = F32_BWD_TOL
        else:
            jax_tol = dict(atol=BF16_JAX_TOL * np.abs(r3).max(),
                           rtol=BF16_JAX_TOL)
            plain_tol = dict(atol=BF16_PLAIN_TOL * np.abs(p3).max(),
                             rtol=BF16_PLAIN_TOL)
            rel = np.linalg.norm(g3 - r3) / np.linalg.norm(r3)
            assert rel <= BF16_JAX_NORM, (name, rel)
        np.testing.assert_allclose(g3, r3, **jax_tol, err_msg=name)
        np.testing.assert_allclose(g3.reshape(b, n, h * d), p3,
                                   **plain_tol, err_msg=name)


# -- the fp32 fusions: csrc/attn_proj_f32.cu (B15) and csrc/ffn_f32.cu (B16) --

def proj_mirror(q, k, v, wp, bp, res, mask_mode, cond_len):
    """attn_proj_f32_kernel's arithmetic on (B, H, N, D) q (scaled in
    fp32), (B, H, M, D) k, v, wp (HO, H*D), bp and the residual: each head
    by the forward's tile recurrence (one warpgroup a head), O / l of every
    head times Wp^T by piece products summed over all of H*D (two
    accumulators folded once), then + bp, then + the residual."""
    b, h, n, d = q.shape
    o = fwd_mirror(q, k, v, mask_mode, cond_len)
    o = o.transpose(1, 2).reshape(b, n, h * d)
    return (piece_matmul(o, wp.t()) + bp) + res


@pytest.mark.parametrize("d,mode,cl", [(32, "prefix_causal", 5),
                                       (64, "none", 0),
                                       (128, "prefix_causal", 2)])
def test_attn_proj_f32_mirror_matches_plain(d, mode, cl):
    """fp32 B15: the mirror against the plain version (q scaled in fp32
    before either), which ``tests/test_torch_fused.py`` holds to
    ``_attention_proj_packed_call`` in interpret mode at these head
    dims."""
    b, n, ho = 1, 40, 128
    h = 256 // d
    rng = np.random.default_rng(d + 11)
    q, k, v = _bnhd(rng, b, n, h, d)
    q = q * np.float32(d ** -0.5)
    wp = (rng.standard_normal((ho, h * d)) * 0.05).astype(np.float32)
    bp = rng.standard_normal(ho).astype(np.float32)
    res = rng.standard_normal((b, n, ho)).astype(np.float32)
    got = proj_mirror(*(_t(a) for a in (q, k, v)),
                      *(torch.from_numpy(a) for a in (wp, bp, res)), mode, cl)
    plain = tatt.attention_proj_plain(
        *(torch.from_numpy(a) for a in (q, k, v, wp, bp, res)), 1.0, mode, cl)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)


def ffn_mirror(x, w1, b1, w2, b2, activation):
    """ffn_f32_kernel's arithmetic: the hidden by piece products over d, +
    b1, the activation in fp32; the output by piece products summed over
    all of h (two accumulators across every hidden chunk, folded once), +
    b2."""
    hidden = _act(piece_matmul(x, w1.t()) + b1, activation)
    return piece_matmul(hidden, w2.t()) + b2


@pytest.mark.parametrize("activation", ["tanh", "sqrelu", "gelu"])
def test_ffn_f32_mirror_matches_jax(activation):
    """fp32 B16: the mirror against ``_ffn_xla`` (in fp32 the function of
    ``_ffn_pallas``, which ``tests/test_torch_fused.py`` holds the plain
    version to in interpret mode) and the plain version."""
    m, d, h = 40, 128, 1024
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((h, d)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((d, h)) * h ** -0.5).astype(np.float32)
    b1, b2 = (rng.standard_normal(s).astype(np.float32) * 0.1
              for s in (h, d))
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    got = ffn_mirror(*args, activation)
    want = np.asarray(jffn._ffn_xla(
        *(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2)), activation))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(
        got.numpy(), tffn.ffn_plain(*args, activation).numpy(), **F32_TOL)


# the H100's limits that the fp32 fusions' plans respect: shared memory a
# block may use (227 KB) with the kernels' static barriers (< 1 KB) beside
# it; at most 8 blocks a portable cluster
SMEM_PER_BLOCK, STATIC_SMEM, CLUSTER_LIMIT = 232448, 1024, 8


@pytest.mark.parametrize("h,d,ho", [(8, 64, 512), (12, 64, 768),
                                    (16, 64, 1280), (16, 32, 512),
                                    (24, 32, 768), (4, 128, 512),
                                    (8, 128, 1024), (2, 64, 128),
                                    (6, 32, 256), (3, 128, 384)])
def test_attn_proj_f32_plan_fits_the_card(h, d, ho):
    """fp32 B15's plan: the cluster's warpgroups (two a block at D <= 64,
    one at 128) take every head, ceil(H / (C W)) each, in the smallest
    cluster of at most 8 whose blocks hold their heads' outputs as
    fragments (64 x D x 3 pieces x 2 bytes a head) beside a q tile and a
    ring of 2-4 stages per warpgroup (a K or V tile, or a (64, 64) Wp box,
    in three pieces) within a block's shared memory."""
    plan = tatt.attn_proj_f32_plan(h, d, ho)
    c, w, hw = plan["cluster"], plan["warpgroups"], plan["heads_per_wg"]
    assert 1 <= c <= CLUSTER_LIMIT and w == (2 if d <= 64 else 1)
    assert hw == -(-h // (c * w)) and c * w * hw >= h
    assert 2 <= plan["stages"] <= 4
    tile, stage = 64 * d * 6, max(64 * d * 6, 64 * 64 * 6)
    assert plan["smem"] == w * (tile * (1 + hw) + plan["stages"] * stage) + 1024
    assert plan["smem"] + STATIC_SMEM <= SMEM_PER_BLOCK
    if c > 1:  # the smallest: one block fewer holds no ring of 2 stages
        fixed = w * tile * (1 + -(-h // ((c - 1) * w))) + 1024
        assert (SMEM_PER_BLOCK - 2 * STATIC_SMEM - fixed) // (w * stage) < 2


@pytest.mark.parametrize("h,d,ho", [(12, 128, 1536), (4, 80, 512),
                                    (4, 64, 96), (3, 32, 512), (0, 64, 512)])
def test_attn_proj_f32_plan_refuses(h, d, ho):
    """No plan for head dims other than 32, 64 and 128, HO or H*D off the
    64-column grid, or more heads than 8 blocks hold."""
    assert tatt.attn_proj_f32_plan(h, d, ho) is None


@pytest.mark.parametrize("d", range(64, 1025, 64))
def test_ffn_f32_plan_fits_the_card(d):
    """fp32 B16's plan: ceil(d / 128) blocks of 128-column slabs (64 at d
    = 64) in a cluster of at most 8, two hidden buffers of one (64, 64)
    chunk's fragments in three pieces beside a ring of 3 stages (an x and a
    W1 tile, or a W2 box, in three pieces) within a block's shared
    memory."""
    plan = tffn.ffn_f32_plan(d)
    c, ds = plan["cluster"], plan["slab"]
    assert c == -(-d // 128) <= CLUSTER_LIMIT and c * ds >= d
    assert ds == (64 if d == 64 else 128) and plan["chunk"] == 64
    tile = 64 * 64 * 6
    stage = max(2 * tile, ds * 64 * 6)
    assert plan["stages"] == 3
    assert plan["smem"] == 2 * tile + 3 * stage + 1024
    assert plan["smem"] + STATIC_SMEM <= SMEM_PER_BLOCK


@pytest.mark.parametrize("d", [0, 96, 1088, 1280])
def test_ffn_f32_plan_refuses(d):
    assert tffn.ffn_f32_plan(d) is None


# -- the opt-in fusions' routes and unfused forms ------------------------------

class _Shaped:
    """The shape and dtype of an array: all that the JAX dispatch of the
    two fusions reads."""

    def __init__(self, *shape, dtype=np.float32):
        self.shape, self.dtype = shape, np.dtype(dtype)
        self.size = int(np.prod(shape))

    def reshape(self, *shape):
        return self

    def astype(self, dtype):
        return self


def jax_runs_attn_proj_kernel(h, d, ho, n, m):
    """Whether the JAX ``attention_proj_packed`` reaches
    ``_attention_proj_packed_call`` on the TPU, by its own tests: its
    entry's (``n >= 8``, ``_packed_supported``), then
    ``_attn_proj_fwd_impl``'s (``_packed_local_ok``,
    ``_attn_proj_supported``)."""
    q3, k3, wp = _Shaped(1, n, h * d), _Shaped(1, m, h * d), _Shaped(h * d,
                                                                    ho)
    return bool(n >= 8 and jatt._packed_supported(h, d, n, m)
                and jatt._packed_local_ok(q3, k3, d)
                and jatt._attn_proj_supported(q3, k3, wp))


def jax_runs_ffn_kernel(monkeypatch, dtype, rows, d, h):
    """Whether the JAX ``fused_ffn`` with ``impl="pallas"`` (as the
    stage-1 FFN calls it) runs ``_ffn_fused`` or ``_ffn_xla``: both
    replaced by recorders, the entry called on shapes alone."""
    ran = []
    monkeypatch.setattr(jffn, "_ffn_fused",
                        lambda x2, *a: ran.append("kernel") or x2)
    monkeypatch.setattr(jffn, "_ffn_xla",
                        lambda x2, *a: ran.append("xla") or x2)
    jffn.fused_ffn(_Shaped(rows, d, dtype=dtype), _Shaped(d, h),
                   _Shaped(h), _Shaped(h, d), _Shaped(d), impl="pallas")
    assert len(ran) == 1
    return ran[0] == "kernel"


@pytest.mark.parametrize("dtype,h,d,ho,n,want", [
    (torch.bfloat16, 12, 64, 768, 256, "attn_proj"),
    (torch.bfloat16, 16, 64, 1280, 1024, "attn_proj"),
    (torch.bfloat16, 16, 64, 1280, 8, "attn_proj"),
    (torch.float32, 12, 64, 768, 256, "attn_proj"),
    (torch.float32, 8, 64, 512, 1024, "attn_proj"),
    (torch.float32, 16, 64, 1280, 1024, "attn_proj"),
    (torch.float32, 16, 32, 512, 256, "attn_proj"),
    (torch.float32, 4, 128, 512, 256, "attn_proj"),
    (torch.float32, 12, 128, 1536, 256, "unported"),
    (torch.float32, 4, 64, 96, 77, "unfused"),
    (torch.float32, 12, 64, 768, 12, "unfused"),
    (torch.bfloat16, 16, 80, 1280, 1024, "unfused"),
    (torch.float32, 16, 80, 1280, 1024, "unfused"),
    (torch.bfloat16, 12, 96, 768, 256, "unfused"),
    (torch.bfloat16, 12, 32, 768, 256, "unported"),
    (torch.bfloat16, 6, 128, 768, 256, "unported"),
    (torch.bfloat16, 17, 64, 768, 256, "unfused"),
    (torch.bfloat16, 18, 64, 768, 256, "unported"),
    (torch.bfloat16, 3, 32, 96, 256, "unfused")])
def test_attn_proj_route(dtype, h, d, ho, n, want):
    """B15 where its plan for the dtype takes the shape (fp32: only where
    the JAX package runs its kernel); else the unfused form, as the JAX
    package computes it there ("unfused") or where it runs its kernel and
    the port's plans refuse the shape ("unported"); decided before any
    launch from dtype and shape; in fp32 "unfused" exactly where the JAX
    dispatch computes ``_attention_proj_xla`` (bf16 takes B15 at any
    length)."""
    assert tatt.attn_proj_route(dtype, h, d, ho, n, n) == want
    if dtype == torch.float32:
        assert (want != "unfused") == jax_runs_attn_proj_kernel(h, d, ho, n,
                                                                n)


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 80, 96, 128, 192, 256,
                               384])
@pytest.mark.parametrize("h,ho,n,m", [(12, 768, 256, 256),
                                      (3, 640, 40, 16)])
def test_jax_fuses_attn_proj_mirrors_the_jax_dispatch(d, h, ho, n, m):
    """``jax_fuses_attn_proj``, which splits the unfused calls into those
    JAX computes unfused too and those it fuses, answers as the JAX
    package's own tests do."""
    for heads, out in ((h, ho), (h + 1, ho), (h, ho + 64), (h, 4224)):
        assert tatt.jax_fuses_attn_proj(heads, d, out, n, m) == \
            jax_runs_attn_proj_kernel(heads, d, out, n, m), (heads, out)


@pytest.mark.parametrize("dtype,rows,d,h", [
    (torch.float32, 256, 512, 2048), (torch.float32, 256, 768, 3072),
    (torch.float32, 256, 1280, 5120), (torch.float32, 7, 512, 2048),
    (torch.float32, 256, 64, 128), (torch.float32, 256, 128, 640),
    (torch.float32, 256, 384, 1536), (torch.float32, 256, 768, 2048),
    (torch.float32, 256, 1536, 1024), (torch.bfloat16, 256, 768, 3072),
    (torch.bfloat16, 256, 1280, 5120), (torch.bfloat16, 256, 512, 2048)])
def test_ffn_route(monkeypatch, dtype, rows, d, h):
    """bf16 on B16 at every width; fp32 on B16 exactly where the JAX
    package runs its kernel (weights of at most 12 MiB: Small's 8.4 MB in
    fp32, not Base's 18.9 MB) and the fp32 plan takes d, "unported" where
    it runs its kernel at a width the plan refuses (d = 1536), else on the
    unfused form."""
    np_dtype = np.float32 if dtype == torch.float32 else jnp.bfloat16
    fused = jax_runs_ffn_kernel(monkeypatch, np_dtype, rows, d, h)
    assert tffn.jax_fuses_ffn(dtype, rows, d, h) == fused
    want = "ffn" if dtype == torch.bfloat16 else (
        "unfused" if not fused else
        "ffn" if tffn.ffn_f32_plan(d) is not None else "unported")
    assert tffn.ffn_route(dtype, rows, d, h) == want


def test_routes_refuse_other_dtypes():
    with pytest.raises(TypeError):
        tatt.attn_proj_route(torch.float16, 12, 64, 768, 256, 256)
    with pytest.raises(TypeError):
        tffn.ffn_route(torch.float16, 256, 768, 3072)


def test_shipped_stage1_configs_route_by_dtype(monkeypatch):
    """Every shipped stage-1 tower: bf16 takes B15 (heads of 64) and B16;
    fp32 takes B15 and B16 exactly where the JAX package runs its kernel
    at the tower's shape, and the unfused forms where it computes them
    too: no shipped tower is "unported" in either dtype."""
    paths = sorted((ROOT / "configs").glob("*vitvq_*.yaml"))
    assert len(paths) >= 5
    for path in paths:
        params = yaml.safe_load(path.read_text())["model"]["params"]
        for tower in (params.get("encoder"), params.get("decoder")):
            if tower is None:
                continue
            n = (params["image_size"] // params["patch_size"]) ** 2
            h, d, dim = tower["heads"], tower.get("dim_head", 64), tower["dim"]
            fused = jax_runs_attn_proj_kernel(h, d, dim, n, n)
            assert tatt.attn_proj_route(torch.float32, h, d, dim, n, n) == (
                "attn_proj" if fused else "unfused"), path.name
            assert tatt.attn_proj_route(torch.bfloat16, h, d, dim, n,
                                        n) == "attn_proj"
            fused = jax_runs_ffn_kernel(monkeypatch, np.float32, n, dim,
                                        tower["mlp_dim"])
            assert tffn.ffn_route(torch.float32, n, dim, tower["mlp_dim"]) == (
                "ffn" if fused else "unfused"), path.name
            assert tffn.ffn_route(torch.bfloat16, n, dim,
                                  tower["mlp_dim"]) == "ffn"


def test_chip_smoke_fused_routes_are_the_routes():
    """The routes that chip_smoke.py's phase 9 asserts for its fp32 Small
    and Base and bf16 Large-with-heads-of-80 trips are those the route
    functions give at those towers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    large = yaml.safe_load((ROOT / "configs/imagenet_vitvq_large.yaml")
                           .read_text())["model"]["params"]
    large["decoder"]["dim_head"] = smoke.D80
    small = yaml.safe_load((ROOT / "configs/imagenet_vitvq_small.yaml")
                           .read_text())["model"]["params"]
    n = smoke.TOKENS
    assert len(smoke.FUSED_ROUTES) == 3
    for label, towers, dtype in (
            ("small float32", small, torch.float32),
            ("base float32", smoke.BASE, torch.float32),
            ("large dec dim_head 80 bfloat16", large, torch.bfloat16)):
        want = smoke.FUSED_ROUTES[label][3]
        for name in ("encoder", "decoder"):
            t = towers[name]
            got = (tatt.attn_proj_route(dtype, t["heads"],
                                        t.get("dim_head", 64), t["dim"], n,
                                        n),
                   tffn.ffn_route(dtype, smoke.CHECK_BATCH * n, t["dim"],
                                  t["mlp_dim"]))
            assert got == want[name], (label, name)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("d", [64, 80])
def test_attention_proj_unfused_matches_jax_xla(d, mode, cl):
    """The unfused B15 on CPU tensors (the attention's plain version, then
    the fp32 projection, bias and residual, one rounding) against
    ``_attention_proj_xla`` in f32: fp32 sums in another order."""
    b, n, h, ho = 2, 40, 2, 96
    rng = np.random.default_rng(d + 7)
    q, k, v = _bnhd(rng, b, n, h, d)
    wp = (rng.standard_normal((ho, h * d)) * 0.05).astype(np.float32)
    bp = rng.standard_normal(ho).astype(np.float32)
    res = rng.standard_normal((b, n, ho)).astype(np.float32)
    scale = d ** -0.5
    got, _ = tatt.attention_proj_unfused(
        *(torch.from_numpy(a) for a in (q, k, v, wp, bp, res)), scale, mode,
        cl)
    q3 = (q * np.float32(scale)).reshape(b, n, h * d)
    want = np.asarray(jatt._attention_proj_xla(
        *(jnp.asarray(a) for a in (q3, k.reshape(b, n, h * d),
                                   v.reshape(b, n, h * d), wp.T, bp, res)),
        mode, cl, d))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("activation", ["tanh", "gelu", "sqrelu"])
def test_ffn_unfused_matches_jax_xla(activation):
    """The unfused B16 (two products, fp32 bias and activation) against
    ``_ffn_xla`` in f32 and the plain version, which in fp32 compute the
    same function."""
    m, d, hidden = 50, 128, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w1 = (rng.standard_normal((hidden, d)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((d, hidden)) * 0.1).astype(np.float32)
    b1, b2 = (rng.standard_normal(s).astype(np.float32) for s in (hidden, d))
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    got = tffn.ffn_unfused(*args, activation)
    want = np.asarray(jffn._ffn_xla(
        *(jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2)), activation))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(
        got.numpy(), tffn.ffn_plain(*args, activation).numpy(), **F32_TOL)
