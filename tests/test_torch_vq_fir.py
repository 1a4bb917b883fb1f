"""The arithmetic of the VQ search on Hopper (``csrc/vq.cu``, B4) and of
the row-streaming FIR blur and its VJP (``csrc/fir.cu``, B6), with their
host plans, on the CPU.

The kernels run only on the card; what they compute is held here:

- B4: a plain-torch mirror of the kernel's scores: the codebook's and each
  query row's three exact bf16 pieces (D padded to 32, codes padded to
  a stage of 128 with zero pieces and |e|^2 = +inf), hi*hi in one fp32 sum
  and the five small cross terms in another, folded once, s = |e|^2 - 2
  (fold); its argmin (the first of equal minima) against ``nearest_plain``,
  0 mismatches outside rows whose two best plain scores lie within 1e-5
  relative; and ``ops.vq.vq_plan`` within a block's shared memory;
- B6: the VJP identity the backward relies on: the blur of the output's
  gradient with the unflipped taps at ``fir_vjp_pad``'s pads against
  JAX's VJP of ``upfirdn2d`` through its Pallas kernel in interpret mode
  (``_fir_fused_bwd``); a mirror of the kernel's order of work (a ring of
  kh partial sums fed one input row at a time, each tap's term rounded
  and added in row-major order, zero taps skipped) against the Pallas
  forward; the autograd wiring of ``ops.upfirdn2d._FIR`` with the launch
  replaced by that mirror (the backward's one launch, counted as
  ``fir_vjp``, its pads and taps, and a second derivative refused); and
  ``ops.upfirdn2d.fir_plan`` at every discriminator blur.
Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.ops import upfirdn2d as jfir
from enhancing_tpu_torch.ops import common as tcommon
from enhancing_tpu_torch.ops import upfirdn2d as tfir
from enhancing_tpu_torch.ops import vq as tvq

SMEM = 232448  # bytes of shared memory an H100 block may use
SMS = 132      # SMs of an H100 SXM
# sm90.cuh: small cross term i multiplies A piece SMALL_A[i] by B piece
# SMALL_B[i] (hi*mid, mid*hi, hi*lo, lo*hi, mid*mid)
SMALL_A, SMALL_B = (0, 1, 0, 2, 1), (1, 0, 2, 0, 1)
BLUR = tfir.make_blur_kernel([1, 3, 3, 1])
# the 256-px discriminator's blurs at batch 8 (chip_smoke.D_BLURS)
D_BLURS = [((8, s, s, c), pad)
           for s, c in ((256, 128), (128, 256), (64, 512), (32, 512),
                        (16, 512), (8, 512)) for pad in ((2, 2), (1, 1))]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- B4: the VQ search

def _pieces(a: torch.Tensor) -> list:
    """hi, mid, lo: each the bf16 nearest to what the earlier ones leave;
    their sum is the fp32 value exactly."""
    out, rest = [], a.float()
    for _ in range(3):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    assert torch.equal(out[0] + out[1] + out[2], a.float())
    return out


def _vq_mirror(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """csrc/vq.cu's scores in plain torch, and their argmin: the split
    pass (pieces and |e|^2 of each code, squares added in column order;
    codes past n zero pieces and |e|^2 = +inf), the query rows' pieces,
    hi*hi and the five small terms in two fp32 sums, folded once."""
    m, d = z.shape
    n = codebook.shape[0]
    dp, n_pad = max(d, 32), -(-n // tvq.VQ_CODES) * tvq.VQ_CODES
    e = torch.zeros((n_pad, dp))
    e[:n, :d] = codebook
    zp = torch.zeros((m, dp))
    zp[:, :d] = z
    esq = torch.zeros(n_pad)
    for c in range(dp):
        esq = esq + e[:, c] * e[:, c]
    esq[n:] = float("inf")
    za, eb = _pieces(zp), _pieces(e)
    big = za[0] @ eb[0].t()
    small = sum(za[a] @ eb[b].t() for a, b in zip(SMALL_A, SMALL_B))
    scores = esq[None, :] - 2.0 * (small + big)
    return torch.argmin(scores, dim=-1).to(torch.int32)


def _plain_scores(z, codebook):
    """|e|^2 - 2 z.e in fp64."""
    return (-2.0 * (z.double() @ codebook.double().t())
            + (codebook.double() ** 2).sum(-1)[None])


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [8192, 1000])
def test_vq_piece_scores_pick_the_plain_codes(n, d):
    rng = np.random.default_rng(n + d)
    m = 4096
    z = rng.standard_normal((m, d)).astype(np.float32)
    cb = rng.standard_normal((n, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    z, cb = _t(z), _t(cb)
    got = _vq_mirror(z, cb)
    want = tvq.nearest_plain(z, cb)
    assert got.dtype == torch.int32 and bool((got < n).all())
    # chip_smoke.py's near-tie rule: the two best plain scores within 1e-5
    # relative
    best2 = torch.topk(-2.0 * (z @ cb.t()) + (cb * cb).sum(-1)[None], 2,
                       dim=-1, largest=False).values
    near_tie = (best2[:, 1] - best2[:, 0]
                <= 1e-5 * best2[:, 0].abs().clamp(min=1e-6))
    assert not bool(((got != want) & ~near_tie).any())
    # where the two differ, the exact (fp64) scores of the two codes lie
    # within that window too
    exact = _plain_scores(z, cb)
    rows = torch.arange(m)
    a, b = exact[rows, got.long()], exact[rows, want.long()]
    assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-7).all())


def test_vq_piece_scores_resolve_duplicated_codes_to_the_lowest_index():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((300, 32)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    cb = _t(np.concatenate([base, base, base]))
    z = _t(base[rng.integers(0, 300, size=1000)])
    got = _vq_mirror(z, cb)
    assert bool((got < 300).all())
    assert torch.equal(got, tvq.nearest_plain(z, cb))


@pytest.mark.parametrize("m,n,d", [(131072, 8192, 32), (8192, 8192, 32),
                                   (1024, 8192, 32), (131109, 8191, 64),
                                   (64, 100, 16)])
def test_vq_plan_fits_a_block(m, n, d):
    plan = tvq.vq_plan(m, n, d, SMS)
    assert plan["smem"] <= SMEM - 2048 and plan["stages"] >= 2
    assert plan["dp"] in (32, 64) and plan["dp"] >= d
    rows = 2 * plan["row_tiles"] * tvq.VQ_ROWS
    assert plan["grid"] * rows >= m > (plan["grid"] - 1) * rows
    assert plan["tiles"] * tvq.VQ_CODES >= n
    # two row tiles a warpgroup only at D <= 32 and where every SM still
    # gets a block
    assert (plan["row_tiles"] == 2) == (d <= 32 and -(-m // 256) >= SMS)
    assert tvq.vq_scratch_bytes(n, d) == (3 * plan["tiles"] * 128
                                          * plan["dp"] * 2
                                          + plan["tiles"] * 128 * 4)


def test_vq_plan_at_the_main_path():
    """Batch 128 of ViT-VQGAN-Base (1024 codes of 32 an image, 8192-entry
    codebook): 512 blocks of 256 rows, 4 ring stages of 128 codes; batch 8
    (a training step): 64 blocks of 128 rows."""
    assert tvq.vq_plan(128 * 1024, 8192, 32, SMS) == dict(
        dp=32, row_tiles=2, stages=4, smem=152576, grid=512, tiles=64)
    assert tvq.vq_plan(8 * 1024, 8192, 32, SMS) == dict(
        dp=32, row_tiles=1, stages=4, smem=128000, grid=64, tiles=64)


# ---- B6: the FIR blur and its VJP

def _flip(k):
    return torch.flip(torch.as_tensor(k, dtype=torch.float32), (0, 1))


# the discriminator's pads, then uneven and negative ones
VJP_CASES = [((2, 9, 11, 16), BLUR.numpy(), (2, 2, 2, 2)),
             ((2, 9, 11, 16), BLUR.numpy(), (1, 1, 1, 1)),
             ((2, 9, 11, 16), np.array([[1.0, 2.0, 0.0, 1.0],
                                        [0.5, -1.0, 3.0, 0.25],
                                        [2.0, 1.0, 1.0, -0.5]], np.float32),
              (3, 0, -1, 1)),
             ((1, 19, 23, 8), np.array([[1.0, 2.0, 0.0], [0.5, -1.0, 3.0]],
                                       np.float32), (-1, 2, 0, -2)),
             ((2, 7, 6, 4), np.arange(1.0, 26.0, dtype=np.float32).reshape(
                 5, 5) / 25.0, (4, -2, 0, 3))]


@pytest.mark.parametrize("shape,k,pad", VJP_CASES)
def test_fir_vjp_is_a_blur_of_the_gradient(interpret, shape, k, pad):
    """x's gradient is the blur of g with the unflipped taps (the plain
    version flips its kernel: it gets the flipped one) at the mirrored
    pads, equal to JAX's VJP through the Pallas kernel."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    assert np.prod(x.shape[1:]) * 4 <= jfir._PALLAS_FIR_VMEM_BUDGET
    out, vjp = jax.vjp(lambda a: jfir.upfirdn2d(a, jnp.asarray(k), pad=pad,
                                                impl="pallas"),
                       jnp.asarray(x))
    g = rng.standard_normal(out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    kh, kw = k.shape
    got = tfir.upfirdn2d_plain(_t(g), _flip(k), 1, 1,
                               tfir.fir_vjp_pad(pad, kh, kw))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def _fir_mirror(x: torch.Tensor, taps, pad) -> torch.Tensor:
    """csrc/fir.cu's order of work in plain torch: input rows o0 - py0 + u
    (zeros outside the image) arrive one at a time; row u adds tap row a to
    the partial sum of output u - a, each tap's term rounded (tap * x) and
    added, taps in row-major order, zero taps skipped; the output whose
    last tap row arrived is rounded to x's dtype."""
    b, h, w, c = x.shape
    kh, kw = len(taps), len(taps[0])
    px0, px1, py0, py1 = pad
    ho, wo = h + py0 + py1 - kh + 1, w + px0 + px1 - kw + 1
    xf = x.float()
    out = torch.empty((b, ho, wo, c), dtype=x.dtype)
    acc = [torch.zeros((b, wo, c)) for _ in range(kh)]
    for u in range(ho + kh - 1):
        r = u - py0
        row = torch.zeros((b, wo + kw - 1, c))
        lo, hi = max(0, -px0 + 0), min(w, wo + kw - 1 - px0)
        if 0 <= r < h and hi > lo:
            row[:, lo + px0:hi + px0] = xf[:, r, lo:hi]
        acc[u % kh] = torch.zeros((b, wo, c))
        for e in range(kw):
            v = row[:, e:e + wo]
            for a in range(kh):
                if taps[a][e] == 0.0:
                    continue
                o = acc[(u - a) % kh]
                acc[(u - a) % kh] = o + torch.tensor(taps[a][e]) * v
        if 0 <= u - (kh - 1) < ho:
            out[:, u - (kh - 1)] = acc[(u + 1) % kh].to(x.dtype)
    return out


@pytest.mark.parametrize("shape,k,pad", VJP_CASES)
def test_fir_kernel_order_of_work_matches_the_pallas_kernel(interpret, shape,
                                                            k, pad):
    x = np.random.default_rng(len(shape) + sum(pad) + 40).standard_normal(
        shape).astype(np.float32)
    taps = tuple(tuple(float(v) for v in row) for row in np.flip(k, (0, 1)))
    ref = jfir._upfirdn2d_pallas_fir(jnp.asarray(x), taps, pad)
    got = _fir_mirror(_t(x), taps, pad)
    assert got.shape == ref.shape
    # the same roundings in the same order: equal up to the compiler's
    # choice of a fused multiply-add on the Pallas side
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("shape,k,pad", VJP_CASES[:1] + VJP_CASES[3:4])
def test_fir_autograd_launches_the_kernel_for_the_vjp(interpret, monkeypatch,
                                                      shape, k, pad):
    """``_FIR`` with the launch replaced by the kernel's mirror: one
    forward launch, one backward launch of the same kernel counted as
    fir_vjp (the unflipped taps, the mirrored pads), the gradient JAX's,
    and a second derivative refused (R1 runs on the plain versions)."""
    calls = []

    def launch(x, taps, p, counter="fir"):
        calls.append((counter, [list(r) for r in taps], p))
        tcommon.LAUNCHES[counter] += 1
        return _fir_mirror(x, taps, p)

    monkeypatch.setattr(tfir, "fir_kernel", launch)
    monkeypatch.setattr(tfir, "use_kernel", lambda *t, **kw: True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    kernel = torch.as_tensor(k)
    tcommon.reset_launches()
    leaf = _t(x).requires_grad_()
    out = tfir.upfirdn2d(leaf, kernel, pad=pad)
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    # g needs a gradient itself, as it does inside R1's penalty (it comes
    # from the layers above the blur)
    gt = _t(g).requires_grad_()
    (got,) = torch.autograd.grad(out, leaf, gt, create_graph=True)
    kh, kw = k.shape
    assert [c[0] for c in calls] == ["fir", "fir_vjp"]
    assert calls[0][1] == torch.flip(kernel, (0, 1)).tolist()
    assert calls[1][1] == kernel.tolist()
    assert calls[1][2] == tfir.fir_vjp_pad(pad, kh, kw)
    assert tcommon.LAUNCHES["fir"] == 1 and tcommon.LAUNCHES["fir_vjp"] == 1
    _, vjp = jax.vjp(lambda a: jfir.upfirdn2d(a, jnp.asarray(k), pad=pad,
                                              impl="pallas"), jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5,
                               rtol=0)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        got.sum().backward()
    tcommon.reset_launches()


@pytest.mark.parametrize("per_sm", [2, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", D_BLURS)
def test_fir_plan_at_the_discriminator_blurs(shape, pad, dtype, per_sm):
    """Forward and VJP blurs of the discriminator: boxes within TMA's 256
    elements per dimension and 16-byte multiples, a block's threads and
    shared memory within bounds, the blocks covering the output in one
    wave where rows of 32 allow it."""
    b, h, w, c = shape
    kh = kw = 4
    ho, wo = h + 2 * pad[0] - 3, w + 2 * pad[0] - 3
    vjp = tfir.fir_vjp_pad(pad + pad, kh, kw)
    for oh, ow in ((ho, wo), (h, w)):  # the forward, then the VJP
        plan = tfir.fir_plan(b, c, oh, ow, kw, dtype, SMS, per_sm)
        n = 4 if dtype == torch.float32 else 8
        vecs = c // n
        assert plan["vecs"] == min(vecs, 32) and plan["vecs"] * n <= 256
        assert plan["cgroups"] * plan["vecs"] >= vecs
        assert plan["strip"] + kw - 1 <= 256 and plan["box"] % 16 == 0
        assert plan["strips"] * plan["strip"] >= ow
        assert plan["chunks"] * plan["rows"] >= oh
        assert (plan["chunks"] - 1) * plan["rows"] < oh
        assert plan["strip"] * plan["vecs"] <= plan["consumers"] <= 256
        assert plan["smem"] <= 48 * 1024
        blocks = (plan["strips"] * plan["chunks"] * plan["cgroups"] * b)
        assert blocks <= per_sm * SMS or plan["chunks"] == 1
    # the VJP's output is x's shape
    assert ho + vjp[2] + vjp[3] - kh + 1 == h
    assert wo + vjp[0] + vjp[1] - kw + 1 == w


def test_fir_plan_at_the_largest_blur():
    """(8, 256, 256, 128) fp32 with pads (2, 2) where 4 blocks fit an SM
    (the H100's answer for the 4-tap kernel): whole pixels of 128 fp32
    channels (32 vectors) a block, 33 strips of 8 columns (an 11-column
    box of 5632 bytes), 2 chunks of 129 rows: 528 blocks of 256 threads,
    the card's one wave."""
    assert tfir.fir_plan(8, 128, 257, 257, 4, torch.float32, SMS, 4) == dict(
        vecs=32, strip=8, strips=33, rows=129, chunks=2, cgroups=1,
        consumers=256, box=5632, smem=4 * 5632 + 128, per_sm=4)
