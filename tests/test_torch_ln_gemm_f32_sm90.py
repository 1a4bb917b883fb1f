"""The arithmetic of the fp32 LN -> GEMM on Hopper (``csrc/ln_gemm_f32.cu``,
fp32 B1), of the LN -> shift -> GEMM on bf16 or fp32 weights
(``csrc/ln_shift_gemm.cu``, B11, on ``csrc/int8_gemm.cuh``), their host
plans and the route that sends fp32 B1's calls of a few rows to B11's
kernel, on the CPU.

The kernels run only on the card; what they compute is held here:

- plain-torch mirrors of each kernel's order of work: fp32 B1's row
  statistics, the normalised row split into three exact bf16 pieces, W's
  three pieces (fp32 W) or its one (bf16 W), the products whose piece
  orders sum to at most 2 with hi*hi in one sum and the small terms in
  another, folded once; B11's LN(x) rounded to x's dtype, the shift in
  x's dtype, the activations' pieces times the weight over 128-wide k
  stages folded smallest piece first, the splits of the plan summed in
  split order. Each against the JAX Pallas kernel in interpret mode
  (``_ln_gemm_pallas``, ``_ln_shift_gemm_pallas``) and the XLA twin, within
  the f32 tolerance of ``tests/test_torch_ops.py`` (bf16 x: two bf16
  steps);
- ``ops.ln_gemm.ln_gemm_f32_plan`` and ``ops.ln_gemm.ln_shift_gemm_plan``
  at every shipped fp32 tower and at the GPT prior's decode shapes, within
  a block's shared memory, and what they refuse;
- ``ops.ln_gemm.ln_gemm_route``, and that ``fused_ln_gemm`` hands a bf16
  weight under fp32 x to the kernels as stored (no widened copy), as the
  LNFUSE mlp and head sites call it.
Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.ops import ln_gemm as jlg
from enhancing_tpu_torch.ops import int8 as tint8
from enhancing_tpu_torch.ops import ln_gemm as tlg

# f32 with another summation order on each side (tests/test_torch_ops.py)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
# bf16 outputs: a rounding on each side at another place, two bf16 steps
BF16_TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
CHUNK = 128  # k a stage of csrc/int8_gemm.cuh
ACTS = [None, "tanh", "sqrelu", "gelu"]
# sm90.cuh: small cross term i multiplies A piece SMALL_A[i] by B piece
# SMALL_B[i] (hi*mid, mid*hi, hi*lo, lo*hi, mid*mid)
SMALL_A, SMALL_B = (0, 1, 0, 2, 1), (1, 0, 2, 0, 1)
SMEM = 232448  # bytes of shared memory an H100 block may use


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _pieces(a: torch.Tensor, n: int) -> list:
    """Each piece the bf16 nearest to what the earlier ones leave."""
    out, rest = [], a.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def _stats(x32: torch.Tensor, eps: float):
    """fp32 row statistics with the fast variance: (mean, rstd)."""
    d = x32.shape[-1]
    mean = x32.sum(-1, keepdim=True) / d
    var = torch.clamp((x32 * x32).sum(-1, keepdim=True) / d - mean * mean,
                      min=0.0)
    return mean, torch.rsqrt(var + eps)


def _b1_f32_mirror(x, gamma, beta, w, b, activation, eps=1e-5):
    """csrc/ln_gemm_f32.cu's order of work in plain torch: LN(x) in fp32,
    its three pieces; W's three pieces (fp32) or W itself (bf16); hi*hi in
    one sum, the small terms in another in the kernel's order, folded once;
    then bias and the activation in fp32."""
    x32 = x.float()
    mean, rstd = _stats(x32, eps)
    xn = (x32 - mean) * (rstd * gamma.float()) + beta.float()
    xp = _pieces(xn, 3)
    if w.dtype == torch.float32:
        wp = _pieces(w, 3)
        terms = [(SMALL_A[i], SMALL_B[i]) for i in range(5)]
    else:
        wp = [w.float()]
        terms = [(1, 0), (2, 0)]
    big = xp[0] @ wp[0].t()
    small = torch.zeros_like(big)
    for a, bb in terms:
        small = small + xp[a] @ wp[bb].t()
    out = small + big
    if b is not None:
        out = out + b.float()
    return tlg._act(out, activation)


def test_pieces_sum_to_the_normalised_row_exactly():
    """hi + mid + lo is LN(x) bit for bit, so the products of the pieces
    are the fp32 products; the three dropped terms are below 2^-24 of
    each product."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((64, 256)) * 3.0
                          ).astype(np.float32))
    mean, rstd = _stats(x, 1e-5)
    xn = (x - mean) * rstd
    hi, mid, lo = _pieces(xn, 3)
    assert torch.equal((hi + mid) + lo, xn)
    w = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    whi, wmid, wlo = _pieces(w, 3)
    dropped = (mid * wlo + lo * wmid + lo * wlo).abs()
    assert bool((dropped <= 2.0 ** -22 * (xn * w).abs() + 1e-30).all())


def _jax_b1(x, gamma, beta, w_dn, b, activation, pallas):
    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
            jnp.asarray(w_dn), jnp.asarray(b), activation, 1e-5)
    fn = jlg._ln_gemm_pallas if pallas else jlg._ln_gemm_xla
    return np.asarray(fn(*args), np.float32)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("m,d,n,bias", [(37, 64, 96, True),
                                        (100, 256, 384, False)])
def test_b1_f32_mirror_matches_jax(interpret, w_dtype, activation, m, d, n,
                                   bias):
    """fp32 B1's arithmetic against ``_ln_gemm_pallas`` in interpret mode
    and ``_ln_gemm_xla``, fp32 and bf16 W (JAX widens a bf16 W to x's
    fp32, exactly), ragged m, each activation, the bias on and off."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = torch.from_numpy((rng.standard_normal((n, d)) / np.sqrt(d)
                          ).astype(np.float32)).to(getattr(torch, w_dtype))
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    bz = b if bias else np.zeros(n, np.float32)
    w_dn = w.float().t().contiguous().numpy()
    t = torch.from_numpy
    got = _b1_f32_mirror(t(x), t(gamma), t(beta), w, t(b) if bias else None,
                         activation).numpy()
    for pallas in (True, False):
        np.testing.assert_allclose(
            got, _jax_b1(x, gamma, beta, w_dn, bz, activation, pallas),
            **F32_TOL)
    np.testing.assert_allclose(
        got, tlg.ln_gemm_plain(t(x), t(gamma), t(beta), w,
                               t(b) if bias else None, activation).numpy(),
        **F32_TOL)


def _stage_sums(pieces, w, k0, k1):
    """Sum over k in [k0, k1) of the activation pieces' products with the
    (n, k) weight (fp32 W: the sum of its three pieces' products, formed
    in one fresh accumulator a stage): each 128-wide k stage a fresh fp32
    sum, its activation pieces added smallest first, then added into the
    running sum."""
    total = torch.zeros(pieces[0].shape[0], w.shape[0])
    for c in range(k0, k1, CHUNK):
        wc = w[:, c:c + CHUNK].float()
        parts = [p[:, c:c + CHUNK] @ wc.t() for p in pieces]
        t = parts[-1]
        for p in parts[-2::-1]:
            t = t + p
        total = total + t
    return total


def _b11_mirror(x, gamma, beta, tm, prev, w, b, activation, eps, splits,
                split_chunks):
    """csrc/ln_shift_gemm.cu's order of work in plain torch: fp32 row
    statistics with the fast variance; LN(x) rounded to x's dtype; with tm
    the shift LN(x) * tm + prev * (1 - tm), each step in x's dtype; its
    pieces (3 for fp32 x, 1 for bf16); the products over the plan's splits
    of 128-wide stages, the partials summed in split order; bias and the
    activation in fp32, one rounding. Returns (y, LN(x))."""
    dt = x.dtype
    x32 = x.float()
    mean, rstd = _stats(x32, eps)
    xn = ((x32 - mean) * (rstd * gamma) + beta).to(dt)
    mixed = xn
    if tm is not None:
        t = tm.to(dt)
        mixed = xn * t + prev.to(dt) * (1.0 - t)
    pieces = _pieces(mixed.float(), 3 if dt == torch.float32 else 1)
    k = w.shape[1]
    acc = torch.zeros(x.shape[0], w.shape[0])
    for sp in range(splits):
        k0 = sp * split_chunks * CHUNK
        acc = acc + _stage_sums(pieces, w, k0,
                                min(k0 + split_chunks * CHUNK, k))
    if b is not None:
        acc = acc + b.float()
    return tlg._act(acc, activation).to(dt), xn


# (x dtype, W dtype): every pair the kernel takes
PAIRS = [("float32", "bfloat16"), ("bfloat16", "bfloat16"),
         ("float32", "float32")]


@pytest.mark.parametrize("x_dtype,w_dtype", PAIRS)
@pytest.mark.parametrize("m,shift,bias,activation", [
    (8, True, True, None), (8, False, False, "sqrelu"),
    (16, True, False, "gelu")])
def test_b11_mirror_matches_jax_kernel(interpret, x_dtype, w_dtype, m,
                                       shift, bias, activation):
    """B11's arithmetic with the plan's splits against
    ``_ln_shift_gemm_pallas`` in interpret mode (w in x's dtype, as the
    JAX wrapper casts it) and the port's plain version, every dtype pair,
    the shift and the bias on and off; LN(x) compared too."""
    d, n = 512, 256
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((m, d)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    tm = rng.uniform(0.0, 1.0, d).astype(np.float32)
    prev = rng.standard_normal((m, d)).astype(np.float32)
    w = torch.from_numpy((rng.standard_normal((n, d)) / np.sqrt(d)
                          ).astype(np.float32)).to(getattr(torch, w_dtype))
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    xj, pj = jnp.asarray(x, jdt), jnp.asarray(prev, jdt)
    tdt = getattr(torch, x_dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    pt = torch.from_numpy(np.array(pj.astype(jnp.float32))).to(tdt)
    wj = jnp.asarray(w.float().t().contiguous().numpy()).astype(jdt)
    out, xn = jlg._ln_shift_gemm_pallas(
        xj, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(tm), pj, wj,
        jnp.asarray(b if bias else np.zeros(n, np.float32)), activation,
        1e-5, shift)
    plan = tlg.ln_shift_gemm_plan(m, d, n, tdt, w.dtype)
    t = torch.from_numpy
    args = (xt, t(gamma), t(beta), t(tm) if shift else None,
            pt if shift else None, w, t(b) if bias else None, activation)
    got, got_xn = _b11_mirror(*args, 1e-5, plan["splits"],
                              plan["split_chunks"])
    tol = F32_TOL if x_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(out, np.float32), **tol)
    np.testing.assert_allclose(got_xn.float().numpy(),
                               np.asarray(xn, np.float32), **tol)
    want, want_xn = tlg.ln_shift_gemm_plain(*args)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **tol)
    np.testing.assert_allclose(got_xn.float().numpy(),
                               want_xn.float().numpy(), **tol)


@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,d,n", [(5, 1040, 136), (13, 6144, 1000),
                                   (3, 256, 200)])
def test_b11_mirror_without_the_shift_is_b1(w_dtype, m, d, n):
    """B1's decode route is B11's kernel without the shift: the mirror
    with the plan's splits against ``ln_gemm_plain`` (fp32 x, the weight as
    stored), at ragged m, d not a multiple of the 128-wide stage and n not
    a multiple of 192."""
    rng = np.random.default_rng(17)
    t = torch.from_numpy
    x = t(rng.standard_normal((m, d)).astype(np.float32))
    gamma = t(1.0 + 0.1 * rng.standard_normal(d)).float()
    beta = t(0.1 * rng.standard_normal(d)).float()
    w = t(rng.standard_normal((n, d)) * 0.02).to(getattr(torch, w_dtype))
    b = t(0.1 * rng.standard_normal(n)).float()
    plan = tlg.ln_shift_gemm_plan(m, d, n, torch.float32, w.dtype)
    got, _ = _b11_mirror(x, gamma, beta, None, None, w, b, "sqrelu", 1e-5,
                         plan["splits"], plan["split_chunks"])
    want = tlg.ln_gemm_plain(x, gamma, beta, w, b, "sqrelu")
    top = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * top,
                               rtol=1e-5)


# the shipped fp32 towers' LN -> GEMM calls (d, n) at batch 8 (M = 8192):
# imagenet_vitvq_small.yaml (and Large's encoder) 512 -> 1536, 2048; Base
# 768 -> 2304, 3072; Large's decoder 1280 -> 3840, 5120
TOWERS = ((512, 1536), (512, 2048), (768, 2304), (768, 3072), (1280, 3840),
          (1280, 5120))


@pytest.mark.parametrize("w_pieces", [3, 1])
@pytest.mark.parametrize("d,n", TOWERS)
def test_ln_gemm_f32_plan_at_the_shipped_towers(w_pieces, d, n):
    """128 x 128 tiles, 32-wide k slices; 5 ring stages of 40 KB with fp32
    W, 8 of 24 KB with bf16 W, within a block's shared memory; one block
    an SM at batch 8 (and a block a tile below 132 tiles)."""
    p = tlg.ln_gemm_f32_plan(8192, d, n, w_pieces)
    stage = 128 * 32 * 4 + w_pieces * 128 * 32 * 2
    assert p["stages"] == (5 if w_pieces == 3 else 8)
    assert p["smem"] == p["stages"] * stage + 1024 <= SMEM - 2048
    assert p["grid"] == 132
    assert (p["tile_m"], p["tile_n"], p["tile_k"]) == (128, 128, 32)
    assert tlg.ln_gemm_f32_plan(512, 768, 2304, w_pieces)["grid"] == 4 * 18


@pytest.mark.parametrize("m,d,n,w_pieces", [(0, 768, 2304, 3),
                                            (8, 760, 2304, 3),
                                            (8, 768, 0, 1), (8, 768, 64, 2),
                                            (8, 0, 64, 1)])
def test_ln_gemm_f32_plan_refuses_what_the_kernel_refuses(m, d, n, w_pieces):
    with pytest.raises(ValueError):
        tlg.ln_gemm_f32_plan(m, d, n, w_pieces)


@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32)])
@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("n", [18432, 24576, 8192])
def test_ln_shift_gemm_plan_at_the_prior_shapes(x_dtype, w_dtype, m, n):
    """The prior's LNFUSE qkv (6144 -> 18432), mlp (-> 24576) and head (->
    8192) at batch 8 and 32: two to four ring stages of 48 KB (bf16 W) or
    96 KB (fp32 W) beside the split's resident pieces, within a block's
    shared memory; no split empty; one block an SM."""
    d = 6144
    p = tlg.ln_shift_gemm_plan(m, d, n, x_dtype, w_dtype)
    w_bytes = 2 if w_dtype == torch.bfloat16 else 4
    pieces = 3 if x_dtype == torch.float32 else 1
    assert p == tint8.int8_gemm_plan(m, d, n, 132, pieces, w_bytes)
    assert 2 <= p["stages"] <= 4
    res = p["split_chunks"] * 2 * 8 * pieces * 128
    slots = 3 * 2 * 8 * 64 * 4
    assert p["smem"] == res + p["stages"] * w_bytes * 24576 + slots + 1024
    assert p["smem"] <= SMEM - 2048
    chunks = d // CHUNK
    assert p["splits"] * p["split_chunks"] >= chunks
    assert (p["splits"] - 1) * p["split_chunks"] < chunks
    assert p["row_tiles"] == m // 8 and p["grid"] <= 132


@pytest.mark.parametrize("m,d,n,x_dtype,w_dtype", [
    (8, 6144, 18432, torch.bfloat16, torch.float32),
    (8, 6140, 18432, torch.float32, torch.bfloat16),
    (0, 6144, 18432, torch.float32, torch.bfloat16),
    (8, 6144, 18432, torch.float32, torch.int8)])
def test_ln_shift_gemm_plan_refuses_what_the_kernel_refuses(m, d, n, x_dtype,
                                                            w_dtype):
    with pytest.raises(ValueError):
        tlg.ln_shift_gemm_plan(m, d, n, x_dtype, w_dtype)


def test_ln_gemm_route():
    """fp32 x of at most LN_GEMM_DECODE_ROWS rows: B11's kernel; more: the
    fp32 tiles; bf16 x: the bf16 kernel; a bf16 weight stays bf16 under
    fp32 x on both fp32 routes, and an fp32 weight under bf16 x is no
    kernel's (the wrapper casts it first)."""
    rows = tlg.LN_GEMM_DECODE_ROWS
    f32, bf16 = torch.float32, torch.bfloat16
    assert rows >= 8  # the LNFUSE decode step's batch
    for w in (f32, bf16):
        assert tlg.ln_gemm_route(1, f32, w) == "decode"
        assert tlg.ln_gemm_route(rows, f32, w) == "decode"
        assert tlg.ln_gemm_route(rows + 1, f32, w) == "f32"
    assert tlg.ln_gemm_route(8, bf16, bf16) == "bf16"
    assert tlg.ln_gemm_route(8192, bf16, bf16) == "bf16"
    for x, w in ((bf16, f32), (f32, torch.int8), (torch.float16, bf16)):
        with pytest.raises(TypeError):
            tlg.ln_gemm_route(8, x, w)


@pytest.mark.parametrize("rows", [8, tlg.LN_GEMM_DECODE_ROWS + 8])
@pytest.mark.parametrize("site", ["mlp", "head"])
def test_fused_ln_gemm_hands_a_bf16_weight_over_as_stored(monkeypatch, rows,
                                                          site):
    """At the LNFUSE mlp site (fp32 residual stream, the bf16 p0 weight and
    bias, squared ReLU) and the head site (no bias), fused_ln_gemm on the
    kernel route hands the kernel the bf16 weight itself, not a widened
    copy; a bf16 x still gets a cast fp32 weight as bf16. The kernel is
    replaced by a recorder that returns the plain version."""
    seen = []

    def recorder(x, gamma, beta, w, b=None, activation=None, eps=1e-5):
        seen.append((tlg.ln_gemm_route(x.shape[0], x.dtype, w.dtype),
                     w.dtype, w.data_ptr()))
        return tlg.ln_gemm_plain(x, gamma, beta, w, b, activation, eps)

    monkeypatch.setattr(tlg, "use_kernel", lambda *t, **kw: True)
    monkeypatch.setattr(tlg, "ln_gemm_kernel", recorder)
    rng = np.random.default_rng(3)
    c, n = 64, 256 if site == "mlp" else 96
    x = torch.from_numpy(rng.standard_normal((rows, 1, c)).astype(np.float32))
    g = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(c)).float()
    bt = torch.from_numpy(0.1 * rng.standard_normal(c)).float()
    w = torch.from_numpy(rng.standard_normal((n, c)) * 0.1).bfloat16()
    b = (torch.from_numpy(rng.standard_normal(n) * 0.1).bfloat16()
         if site == "mlp" else None)
    act = "sqrelu" if site == "mlp" else None
    got = tlg.fused_ln_gemm(x, g, bt, w, b, activation=act)
    route, dtype, ptr = seen[-1]
    assert route == ("decode" if rows <= tlg.LN_GEMM_DECODE_ROWS else "f32")
    assert dtype == torch.bfloat16 and ptr == w.data_ptr()
    want = tlg.ln_gemm_plain(x.reshape(rows, c), g, bt, w, b, act)
    np.testing.assert_allclose(got.reshape(rows, n).numpy(), want.numpy(),
                               rtol=0, atol=0)
    tlg.fused_ln_gemm(x.bfloat16(), g, bt, w.float(), None)
    assert seen[-1][:2] == ("bf16", torch.bfloat16)
