"""The host side and the arithmetic of the port's decode attention (B9,
``csrc/decode_attention.cu``), on the CPU.

The kernel cuts each (batch row, head) pair's keys into
``DECODE_SPLITS`` contiguous splits, one a warp of a thread-block cluster;
a warp walks its split in ring stages of ``4 / itemsize`` keys, keeps a
running max m, a sum l of exp(s - m) and an fp32 O rescaled once a stage,
and the cluster merges the splits and the new token at the end.
``ops.attention.decode_plan`` and ``decode_key_splits`` mirror its plan;
the recurrence is written out here and held to the plain version and to
the JAX kernel ``_decode_pallas`` in interpret mode, for a bf16 cache
under bf16 and fp32 q and an int8 cache under fp32 q, at cur_len 0, 1,
31, 32, 33 and ctx and a ragged vector. Inputs are made with numpy from a
seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu_torch.ops import attention as tatt

CTX, HEAD_DIM, HEADS, BATCH = 256, 64, 4, 3
CURS = [0, 1, 31, 32, 33, CTX, "ragged"]
RAGGED = [0, 33, CTX]
# 227 KB of shared memory a block, less the static barriers
SMEM_LIMIT = 232448 - 1024


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128, 384, 512])
def test_decode_plan_fits_a_block(itemsize, d):
    """16 splits as 2 blocks of 8 warps; a stage of 4 / itemsize keys is
    8 D bytes of K and V rows; the whole plan fits one block's shared
    memory (each warp's ring also holds its partial O and (m, l) at the
    end), and at the prior's D = 384 three blocks fit an SM, so the 256
    blocks of its batch-8 step are resident at once on 132 SMs."""
    if (d * itemsize) % 16:
        pytest.skip("no 16-byte head rows")
    plan = tatt.decode_plan(d, itemsize)
    assert plan["cluster"] * plan["warps"] == tatt.DECODE_SPLITS == 16
    assert plan["keys_per_stage"] * itemsize == 4
    assert plan["smem"] <= SMEM_LIMIT
    ring = plan["warps"] * plan["stages"] * 8 * d
    assert plan["smem"] == ring >= plan["warps"] * (4 * d + 8)
    if d == 384:
        assert 3 * plan["smem"] <= 228 * 1024
        assert 132 * 3 >= 8 * 16 * plan["cluster"]


@pytest.mark.parametrize("d,itemsize", [(6, 4), (516, 4), (1024, 1),
                                        (8, 1), (0, 2), (64, 3)])
def test_decode_plan_refuses_what_the_kernel_does_not_take(d, itemsize):
    """A head dim that is no multiple of 4, above 512, or with head rows
    that are no multiple of 16 bytes; an element size other than 1, 2, 4."""
    with pytest.raises(ValueError):
        tatt.decode_plan(d, itemsize)


def _check_splits(ranges, cur):
    per = -(-cur // tatt.DECODE_SPLITS)
    assert len(ranges) == tatt.DECODE_SPLITS
    at = 0
    for k0, k1 in ranges:
        assert k0 == at and k0 <= k1 <= cur and k1 - k0 <= per
        at = k1
    assert at == cur


@pytest.mark.parametrize("cur", [0, 1, 15, 16, 17, 31, 32, 33, 511, 512,
                                 1025])
def test_decode_key_splits_cover_the_row(cur):
    """A scalar cur_len: 16 contiguous ranges of ceil(cur / 16) keys (the
    last ones short or empty) that cover [0, cur) in order; cur 0 leaves
    every split empty, so the output is v_new."""
    ranges = tatt.decode_key_splits(cur, 1025)
    _check_splits(ranges, cur)
    if cur == 0:
        assert all(k0 == k1 for k0, k1 in ranges)


def test_decode_key_splits_of_a_ragged_vector():
    """A (B,) vector: each row split on its own length, clamped to [0, ctx]
    as the kernel and ``_decode_xla``'s mask read it; a scalar outside
    raises."""
    ctx = 1032
    cur = torch.tensor([-3, 0, 1, 513, ctx, ctx + 9, 1024, 31])
    rows = tatt.decode_key_splits(cur, ctx)
    for c, ranges in zip(cur.tolist(), rows):
        _check_splits(ranges, min(max(c, 0), ctx))
    for bad in (-1, ctx + 1):
        with pytest.raises(ValueError):
            tatt.decode_key_splits(bad, ctx)


# -- the recurrence ------------------------------------------------------------

def decode_recurrence(q3, kc, vc, kn, vn, cur_len, head_dim, k_scale=None,
                      v_scale=None):
    """csrc/decode_attention.cu's arithmetic on q3, kn, vn (B, H*D) and one
    layer's kc, vc (B, ctx, H*D) (int8 with (B, ctx) scales, or the
    dtype the kernel reads): fp32 q . k per key (times the key's scale),
    per split and ring stage of 4 / itemsize keys the running max m, l and
    O rescaled by exp(m_old - m) and P V summed in fp32 (the weights times
    the values' scales); then the 16 splits and the new token merged with
    weights exp(m_i - M) / (sum l_i exp(m_i - M) + exp(s_self - M)), the
    output rounded once to q's dtype."""
    b, ctx, hd = kc.shape
    h = hd // head_dim
    keys = 4 // kc.element_size()
    out = torch.zeros(b, hd)
    rows = tatt.decode_key_splits(cur_len, ctx)
    if isinstance(cur_len, int):
        rows = [rows] * b
    for r in range(b):
        for hh in range(h):
            lanes = slice(hh * head_dim, (hh + 1) * head_dim)
            q = q3[r, lanes].float()
            kr, vr = kc[r, :, lanes].float(), vc[r, :, lanes].float()
            parts = []
            for k0, k1 in rows[r]:
                m, l, o = -torch.inf, torch.tensor(0.0), torch.zeros(
                    head_dim)
                for key in range(k0, k1, keys):
                    sl = slice(key, min(key + keys, k1))
                    s = kr[sl] @ q
                    p_scale = torch.ones(s.shape)
                    if k_scale is not None:
                        s = s * k_scale[r, sl]
                        p_scale = v_scale[r, sl]
                    m_new = max(m, float(s.max()))
                    alpha = torch.exp(torch.tensor(m - m_new))
                    p = torch.exp(s - m_new)
                    l = l * alpha + p.sum()
                    o = o * alpha + (p * p_scale) @ vr[sl]
                    m = m_new
                parts.append((m, l, o))
            s_self = q @ kn[r, lanes].float()
            big = max([float(s_self)] + [m for m, _, _ in parts])
            e = [torch.exp(torch.tensor(m - big)) for m, _, _ in parts]
            e_self = torch.exp(s_self - big)
            inv = 1.0 / (sum(ei * l for ei, (_, l, _) in zip(e, parts))
                         + e_self)
            acc = e_self * inv * vn[r, lanes].float()
            for ei, (_, _, o) in zip(e, parts):
                acc = acc + ei * inv * o
            out[r, lanes] = acc
    return out.to(q3.dtype)


def _inputs(rng, kind, cur):
    """q3 (pre-scaled), the (B, ctx, H*D) cache, k_new, v_new and, for an
    int8 cache, its per-row scales; rows past each row's cur_len hold 1e6
    (127 at a scale of 1e6 in int8): a version that read one would show
    it."""
    hd = HEADS * HEAD_DIM
    dead = np.arange(CTX)[None, :] >= np.reshape(cur, (-1, 1))
    dead = np.broadcast_to(dead, (BATCH, CTX))
    q3, kn, vn = (rng.standard_normal((BATCH, hd)).astype(np.float32)
                  for _ in range(3))
    q3 *= np.float32(HEAD_DIM ** -0.5)
    k, v = (rng.standard_normal((BATCH, CTX, hd)).astype(np.float32)
            for _ in range(2))
    scales = None
    if kind == "int8":
        scales = []
        for i, t in enumerate((k, v)):
            sc = np.abs(t).max(-1) / np.float32(127)
            qt = np.clip(np.rint(t / sc[..., None]), -127, 127)
            qt[dead], sc[dead] = 127, 1e6
            scales.append(torch.from_numpy(sc.astype(np.float32)))
            (k, v)[i][...] = qt
        k, v = (torch.from_numpy(t).to(torch.int8) for t in (k, v))
    else:
        k[dead], v[dead] = 1e6, 1e6
        k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in (k, v))
    qd = torch.bfloat16 if kind == "bf16" else torch.float32
    q3, kn, vn = (torch.from_numpy(t).to(qd) for t in (q3, kn, vn))
    if kind == "f32q":  # fp32 q under a bf16 cache: new k, v in the cache's
        kn, vn = kn.to(torch.bfloat16), vn.to(torch.bfloat16)
    return q3, k, v, kn, vn, scales


def _row_close(got, want, frac, rtol):
    """|got - want| <= frac * the row's largest |want| + rtol * |want|."""
    got, want = got.float(), want.float()
    limit = frac * want.abs().amax(-1, keepdim=True) + rtol * want.abs()
    err = (got - want).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


def _jax(q3, k, v, kn, vn, cur, scales):
    """``_decode_pallas`` in interpret mode, the cache as a one-layer stack
    (the same in every dtype as the port's inputs)."""
    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    ks = vs = None
    if scales is not None:
        ks, vs = (j(s)[None] for s in scales)
    out = jatt._decode_pallas(j(q3), j(k)[None], j(v)[None], j(kn), j(vn),
                              jnp.asarray(cur, jnp.int32), HEAD_DIM,
                              block_k=128, layer=jnp.int32(0), ks=ks, vs=vs)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("cur", CURS)
@pytest.mark.parametrize("kind", ["bf16", "f32q", "int8"])
def test_decode_recurrence_matches_plain_and_jax(interpret, kind, cur):
    """Each batch row is held to its own output's scale (|out| falls with
    cur_len). Where P V meets bf16 on the plain side (a bf16 cache or q:
    the plain version casts the weights to the values' dtype and rounds its
    sums, the recurrence sums in fp32 and rounds once), phase 3's limit,
    2^-7 of the row's largest |plain| + 2^-7 relative, against the plain
    version and the JAX kernel, which round alike; against the same
    function in fp32 on the same values, one rounding of a bf16 output
    (2^-12 of the row's largest + 2^-8 relative) or, with fp32 q, fp32
    sums in another order (1e-5 + 1e-5 relative). The int8 cache under
    fp32 q: 1e-5 + 1e-5 relative against the plain version on the
    dequantised cache, and the JAX package's own decode-kernel tolerance
    (1e-4, 2e-4) against ``_decode_pallas``."""
    rng = np.random.default_rng(7 + CURS.index(cur))
    cur = np.array(RAGGED, np.int32) if cur == "ragged" else cur
    q3, k, v, kn, vn, scales = _inputs(rng, kind, cur)
    cur_t = cur if isinstance(cur, int) else torch.from_numpy(cur)
    ks, vs = scales if scales is not None else (None, None)
    got = decode_recurrence(q3, k, v, kn, vn, cur_t, HEAD_DIM, ks, vs)
    assert got.dtype == q3.dtype and bool(torch.isfinite(got).all())
    jax_out = _jax(q3, k, v, kn, vn, cur, scales)
    if kind == "int8":
        kp, vp = tatt.dequant_cache(k, v, ks, vs, q3.dtype)
        want = tatt.decode_attention_plain(q3, kp, vp, kn, vn, cur_t,
                                           HEAD_DIM)
        _row_close(got, want, 1e-5, 1e-5)
        np.testing.assert_allclose(got.numpy(), jax_out.numpy(), atol=1e-4,
                                   rtol=2e-4)
        return
    want = tatt.decode_attention_plain(q3, k, v, kn, vn, cur_t, HEAD_DIM)
    _row_close(got, want, 2.0 ** -7, 2.0 ** -7)
    _row_close(got, jax_out, 2.0 ** -7, 2.0 ** -7)
    want32 = tatt.decode_attention_plain(
        q3.float(), k.float(), v.float(), kn.float(), vn.float(), cur_t,
        HEAD_DIM)
    if kind == "bf16":
        _row_close(got, want32, 2.0 ** -12, 2.0 ** -8)
    else:
        _row_close(got, want32, 1e-5, 1e-5)
