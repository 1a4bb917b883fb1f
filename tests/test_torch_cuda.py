"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from enhancing_tpu_torch.ops import attention as att
from enhancing_tpu_torch.ops import cache
from enhancing_tpu_torch.ops import common
from enhancing_tpu_torch.ops import fused_act as fa
from enhancing_tpu_torch.ops import int8
from enhancing_tpu_torch.ops import ln_gemm as lg
from enhancing_tpu_torch.ops import upfirdn2d as fir
from enhancing_tpu_torch.ops import vq

pytestmark = pytest.mark.cuda

# bf16 outputs: a rounding on each side plus the normalised row rounding
# at another place, so two bf16 steps; f32: another summation order
BF16_TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
F32_TOL = dict(atol=1e-4, rtol=1e-5)
# attention: P rounds to bf16 against the running row max in the kernel
ATTN_TOL = dict(atol=1e-2, rtol=2.0 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _row_close(got, want, frac, rtol):
    """|got - want| <= frac * the row's largest |want| + rtol * |want|: a
    decode-attention row is held to its own output's scale, which falls
    with its cur_len, not to that of another row of a ragged batch."""
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs()
    limit = frac * want.abs().amax(-1, keepdim=True) + rtol * want.abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", [None, "tanh", "sqrelu", "gelu"])
@pytest.mark.parametrize("m,d,n,bias", [(100, 256, 136, True),
                                        (2048, 768, 2304, False)])
def test_ln_gemm_kernel_matches_plain(cuda, dtype, activation, m, d, n, bias):
    x = _randn(cuda, m, d, dtype=dtype, scale=2.0)
    gamma = 1.0 + 0.1 * _randn(cuda, d)
    beta = 0.1 * _randn(cuda, d)
    w = _randn(cuda, n, d, dtype=dtype, scale=d ** -0.5)
    b = 0.1 * _randn(cuda, n) if bias else None
    before = common.LAUNCHES["ln_gemm"]
    got = lg.fused_ln_gemm(x, gamma, beta, w, b, activation=activation)
    assert common.LAUNCHES["ln_gemm"] == before + 1
    want = lg.ln_gemm_plain(x, gamma, beta, w, b, activation)
    _close(got, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(37, 768), (4096, 768), (5, 64)])
def test_layernorm_kernel_matches_plain(cuda, dtype, m, d):
    x = _randn(cuda, m, d, dtype=dtype, scale=3.0) + 1.0
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    got = lg.fused_layernorm(x, gamma, beta)
    want = lg.layernorm(x, gamma, beta)
    _close(got, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


@pytest.mark.parametrize("b,n,h,d,mode,cl", [
    (2, 1024, 12, 64, "none", 0),
    (1, 16, 2, 64, "none", 0),
    (2, 1025, 4, 64, "prefix_causal", 5),
    (1, 130, 3, 32, "prefix_causal", 70),
    (2, 77, 2, 128, "none", 0),
])
def test_attention_kernel_matches_plain(cuda, b, n, h, d, mode, cl):
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    got = att.multihead_attention_packed_qkv(qkv, h, d, mask_mode=mode,
                                             cond_len=cl)
    want = att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode, cl)
    _close(got, want, ATTN_TOL)


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    qkv = _randn(cuda, 1, 16, 3 * 2 * 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.multihead_attention_packed_qkv(qkv, 2, 48)
    with pytest.raises(TypeError):
        att.multihead_attention_packed_qkv(
            _randn(cuda, 1, 16, 3 * 2 * 64), 2, 64)


@pytest.mark.parametrize("m,n,d", [(300, 1000, 32), (4096, 8192, 32),
                                   (77, 128, 16)])
def test_vq_kernel_matches_plain(cuda, m, n, d):
    z = torch.nn.functional.normalize(_randn(cuda, m, d), dim=-1)
    cb = torch.nn.functional.normalize(_randn(cuda, n, d), dim=-1)
    got = vq.nearest_codebook_indices(z, cb)
    want = vq.nearest_plain(z, cb)
    scores = -2.0 * z @ cb.t() + (cb * cb).sum(-1)[None]
    best2 = torch.topk(scores, 2, dim=-1, largest=False).values
    near_tie = best2[:, 1] - best2[:, 0] <= 1e-5 * best2[:, 0].abs()
    assert not ((got != want) & ~near_tie).any()


def test_vq_kernel_ties_go_to_the_lowest_index(cuda):
    base = torch.nn.functional.normalize(_randn(cuda, 300, 32), dim=-1)
    cb = torch.cat([base, base, base])
    z = base[torch.randint(0, 300, (1000,), generator=cuda, device="cuda")]
    got = vq.nearest_codebook_indices(z, cb)
    assert (got < 300).all()


def test_tiny_model_round_trip_goes_through_the_kernels(cuda):
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    tower = dict(dim=64, depth=2, heads=2, mlp_dim=128)
    model = ViTVQ(image_size=32, patch_size=8, encoder=tower, decoder=tower,
                  quantizer=dict(embed_dim=16, n_embed=128),
                  dtype="bfloat16", device="cuda")
    x = torch.rand(3, 32, 32, 3, generator=cuda, device="cuda")
    common.reset_launches()
    rec = model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    assert common.LAUNCHES == {"ln_gemm": 8, "attention": 4, "layernorm": 2,
                               "vq": 1, "attention_bwd": 0, "fir": 0,
                               "fused_act": 0, "attention_bnhd": 0,
                               "decode_attention": 0, "cache_row_update": 0,
                               "ln_shift_gemm": 0, "int8_gemm": 0,
                               "int8_ln_gemm": 0, "int8_mlp": 0}
    assert rec.shape == (3, 32, 32, 3) and torch.isfinite(rec).all()


# the 256-px StyleGAN discriminator's blurs: before each block's strided
# 3x3 conv (pads 2, 2) and its strided 1x1 skip (pads 1, 1)
BLUR_SHAPES = [(8, 256, 256, 128), (8, 128, 128, 256), (8, 64, 64, 512),
               (8, 32, 32, 512), (8, 16, 16, 512), (8, 8, 8, 512)]


def _grad_close(got, want, label):
    """bf16 gradients: the kernel rounds dS to bf16 before its products
    and the plain version's autograd rounds dP instead, each one bf16 step
    (2^-8) on terms summed over N keys; held to 2^-6 of the largest
    plain value plus 2^-6 relative."""
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    bad = err > 2.0 ** -6 * scale + 2.0 ** -6 * want.float().abs()
    assert not bad.any(), (label, err.max().item(), scale)


@pytest.mark.parametrize("b,n,h,d,mode,cl", [
    (2, 1024, 12, 64, "none", 0),
    (1, 16, 2, 64, "none", 0),
    (2, 1025, 4, 64, "prefix_causal", 5),
    (1, 130, 3, 32, "prefix_causal", 70),
    (2, 77, 2, 128, "none", 0),
    (1, 200, 2, 128, "prefix_causal", 0),
])
def test_attention_bwd_kernel_matches_plain(cuda, b, n, h, d, mode, cl):
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = _randn(cuda, b, n, h * d, dtype=torch.bfloat16)
    before = common.LAUNCHES["attention_bwd"]
    got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    assert common.LAUNCHES["attention_bwd"] == before + 1
    want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all()
        _grad_close(g, w, "d" + name)


def test_attention_autograd_goes_through_both_kernels(cuda):
    qkv = _randn(cuda, 2, 64, 3 * 2 * 64, dtype=torch.bfloat16)
    qkv.requires_grad_()
    do = _randn(cuda, 2, 64, 2 * 64, dtype=torch.bfloat16)
    common.reset_launches()
    out = att.multihead_attention_packed_qkv(qkv, 2, 64)
    (got,) = torch.autograd.grad(out, qkv, do)
    assert common.LAUNCHES["attention"] == 1
    assert common.LAUNCHES["attention_bwd"] == 1
    ref = qkv.detach().requires_grad_()
    out_p = att.attention_packed_qkv_plain(ref, 2, 64, 64 ** -0.5)
    (want,) = torch.autograd.grad(out_p, ref, do)
    _grad_close(got, want, "dqkv")


@pytest.mark.parametrize("shape", BLUR_SHAPES)
@pytest.mark.parametrize("pad", [(2, 2), (1, 1)])
def test_fir_kernel_matches_plain_at_the_discriminator_shapes(cuda, shape,
                                                              pad):
    x = _randn(cuda, *shape)
    k = fir.make_blur_kernel([1, 3, 3, 1])
    before = common.LAUNCHES["fir"]
    got = fir.upfirdn2d(x, k, pad=pad)
    assert common.LAUNCHES["fir"] == before + 1
    want = fir.upfirdn2d_plain(x, k, 1, 1, pad)
    # f32: the same 16 products in another order (and fused multiply-add)
    _close(got, want, dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [(-1, 2, 0, -2), (3, 0, 1, 1), (0, 0, 0, 0)])
def test_fir_kernel_negative_and_uneven_pads(cuda, dtype, pad):
    x = _randn(cuda, 2, 19, 23, 64, dtype=dtype)
    k = torch.tensor([[1.0, 2.0, 0.0], [0.5, -1.0, 3.0]])
    got = fir.upfirdn2d(x, k, pad=pad)
    want = fir.upfirdn2d_plain(x, k, 1, 1, pad)
    assert got.shape == want.shape
    # bf16: one rounding of an fp32 sum on each side
    _close(got, want, F32_TOL if dtype == torch.float32
           else dict(atol=2.0 ** -7, rtol=2.0 ** -7))


def test_fir_backward_is_the_plain_gradient(cuda):
    x = _randn(cuda, 2, 16, 16, 128).requires_grad_()
    g = _randn(cuda, 2, 17, 17, 128)
    k = fir.make_blur_kernel([1, 3, 3, 1])
    (got,) = torch.autograd.grad(fir.upfirdn2d(x, k, pad=(2, 2)), x, g)
    ref = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(fir.upfirdn2d_plain(ref, k, 1, 1, (2, 2)),
                                  ref, g)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 256, 256, 128), (8, 512), (3, 5, 24)])
def test_fused_act_kernel_matches_plain(cuda, dtype, shape):
    x = _randn(cuda, *shape, dtype=dtype)
    bias = 0.3 * _randn(cuda, shape[-1])
    before = common.LAUNCHES["fused_act"]
    got = fa.fused_leaky_relu(x, bias)
    assert common.LAUNCHES["fused_act"] == before + 1
    want = fa.fused_act_plain(x, bias)
    # the same roundings in the same order on both sides
    _close(got, want, dict(atol=0.0, rtol=0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_act_backward_matches_autograd_of_plain(cuda, dtype):
    x = _randn(cuda, 4, 8, 8, 256, dtype=dtype).requires_grad_()
    bias = (0.3 * _randn(cuda, 256)).requires_grad_()
    g = _randn(cuda, 4, 8, 8, 256, dtype=dtype)
    got = torch.autograd.grad(fa.fused_leaky_relu(x, bias), (x, bias), g)
    xr, br = (t.detach().requires_grad_() for t in (x, bias))
    want = torch.autograd.grad(fa.fused_act_plain(xr, br), (xr, br), g)
    # dx: scale * slope rounded once against twice; db: a sum of 256
    # products over another order (bf16: of bf16-rounded terms)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _close(got[0], want[0], tol)
    _close(got[1], want[1], dict(atol=1e-3 if dtype == torch.float32
                                 else 0.5, rtol=1e-3))


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        fa.fused_leaky_relu(_randn(cuda, 4, 6), _randn(cuda, 6))
    with pytest.raises(ValueError):
        fir.upfirdn2d(_randn(cuda, 1, 8, 8, 6), fir.make_blur_kernel([1, 1]))
    q = _randn(cuda, 1, 16, 2 * 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.attention_bwd_kernel(q, q, q, q, 2, 48)


def test_tiny_training_step_goes_through_every_kernel(cuda):
    """A bf16 GAN step with R1 on the card: the VQ search runs inside the
    step (its inputs are detached), every kernel launches, and the R1
    forward takes the plain versions."""
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    from enhancing_tpu_torch.train import (GANTrainState, make_ae_optimizer,
                                           make_vitvq_train_step)
    tower = dict(dim=64, depth=2, heads=2, mlp_dim=128)
    loss = {"target": "enhancing_tpu_torch.losses.vqperceptual."
                      "VQLPIPSWithDiscriminator",
            "params": {"image_size": 32, "perceptual_weight": 0.1,
                       "allow_random_lpips": True}}
    model = ViTVQ(image_size=32, patch_size=8, encoder=tower, decoder=tower,
                  quantizer=dict(embed_dim=16, n_embed=128), loss=loss,
                  dtype="bfloat16", device="cuda")
    state = GANTrainState(
        0, *make_ae_optimizer(model.module.parameters(), 1e-4),
        *make_ae_optimizer(model.loss.discriminator.parameters(), 1e-4))
    step = make_vitvq_train_step(model, model.loss)
    x = torch.rand(4, 32, 32, 3, generator=cuda, device="cuda")
    common.reset_launches()
    log = step(state, x, do_r1=True)
    torch.cuda.synchronize()
    # two AE forwards of 2 + 2 layers, one AE backward, three D forwards
    # at 32 px (6 blurs, 9 bias + leaky ReLUs each), one plain D forward
    assert common.LAUNCHES == {"ln_gemm": 16, "attention": 8,
                               "layernorm": 4, "vq": 2, "attention_bwd": 4,
                               "fir": 18, "fused_act": 27,
                               "attention_bnhd": 0, "decode_attention": 0,
                               "cache_row_update": 0, "ln_shift_gemm": 0,
                               "int8_gemm": 0, "int8_ln_gemm": 0,
                               "int8_mlp": 0}
    assert {k: v for k, v in common.PLAIN_CALLS.items() if v} == {
        "fir": 6, "fused_act": 9}
    assert all(torch.isfinite(v).all() for v in log.values()), log


# -- the stage-2 GPT prior's kernels ------------------------------------------

@pytest.mark.parametrize("b,n,h,d,mode,cl", [
    (2, 1025, 16, 384, "prefix_causal", 1),
    (2, 1025, 16, 384, "prefix_causal", 3),
    (8, 1, 16, 384, "prefix_causal", 1),
    (1, 200, 2, 384, "none", 0),
    (2, 130, 4, 64, "prefix_causal", 5),
    (1, 77, 2, 128, "none", 0),
    (1, 40, 2, 32, "prefix_causal", 2),
])
def test_attention_bnhd_kernel_matches_plain(cuda, b, n, h, d, mode, cl):
    q, k, v = (_randn(cuda, b, n, h, d, dtype=torch.bfloat16)
               for _ in range(3))
    before = common.LAUNCHES["attention_bnhd"]
    got = att.multihead_attention_bnhd(q, k, v, mask_mode=mode, cond_len=cl)
    assert common.LAUNCHES["attention_bnhd"] == before + 1
    want = att.attention_bnhd_plain(q, k, v, d ** -0.5, mode, cl)
    assert got.shape == (b, n, h, d)
    _close(got, want, ATTN_TOL)


def test_attention_bnhd_kernel_reads_lane_slices(cuda):
    """q, k and v as the [q | k | v] lane slices of one buffer."""
    b, n, h, d = 2, 100, 2, 384
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    got = att.multihead_attention_bnhd(q, k, v, mask_mode="prefix_causal",
                                       cond_len=1)
    want = att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal", 1)
    _close(got, want, ATTN_TOL)


def test_attention_bnhd_kernel_refuses_what_it_does_not_take(cuda):
    q = _randn(cuda, 1, 16, 2, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.multihead_attention_bnhd(q, q, q)
    q = _randn(cuda, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        att.multihead_attention_bnhd(q, q, q)


def _stack(gen, layers, b, ctx, hd, cur, dtype):
    """Random (L, B, ctx, H*D) k and v stacks whose rows at or past each
    row's cur_len hold 1e6, which a kernel that read them would show."""
    k = _randn(gen, layers, b, ctx, hd)
    v = _randn(gen, layers, b, ctx, hd)
    dead = (torch.arange(ctx, device="cuda")[None, :]
            >= torch.as_tensor(cur, device="cuda").reshape(-1, 1))
    for t in (k, v):
        t.masked_fill_(dead[None, :, :, None].expand_as(t), 1e6)
    return k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cur", [1, 255, 256, 513, 1024, "ragged",
                                 "outside"])
def test_decode_attention_kernel_matches_plain(cuda, dtype, cur):
    layers, b, ctx, h, d = 3, 4, 1032, 16, 384
    if cur == "ragged":
        cur = torch.tensor([1, 255, 513, 1024], dtype=torch.int32,
                           device="cuda")
    elif cur == "outside":  # clamped to [0, ctx] on both routes
        cur = torch.tensor([-3, 1032, 1100, 7], dtype=torch.int32,
                           device="cuda")
    k, v = _stack(cuda, layers, b, ctx, h * d, cur, dtype)
    q3, kn, vn = (_randn(cuda, b, h * d, dtype=dtype, scale=s)
                  for s in (d ** -0.5, 1.0, 1.0))
    before = common.LAUNCHES["decode_attention"]
    got = att.decode_attention_stacked(q3, k, v, kn, vn, cur, 1, head_dim=d)
    assert common.LAUNCHES["decode_attention"] == before + 1
    want = att.decode_attention_plain(q3, k[1], v[1], kn, vn, cur, d)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        # the plain version rounds the weights, their sum with V and the
        # quotient to bf16, the kernel sums in fp32 and rounds once: 2^-8
        # of the row's largest |plain| + 2^-7 relative. Against the same
        # function in fp32: one bf16 rounding of the output.
        _row_close(got, want, 2.0 ** -8, 2.0 ** -7)
        want = att.decode_attention_plain(q3.float(), k[1].float(),
                                          v[1].float(), kn.float(),
                                          vn.float(), cur, d)
        _row_close(got, want, 2.0 ** -12, 2.0 ** -8)
    else:  # another summation order
        _close(got, want, dict(atol=1e-5, rtol=1e-5))


def test_decode_attention_unstacked_cache(cuda):
    b, ctx, h, d = 3, 64, 2, 64
    k, v = _stack(cuda, 1, b, ctx, h * d, 40, torch.bfloat16)
    q3, kn, vn = (_randn(cuda, b, h * d, dtype=torch.bfloat16)
                  for _ in range(3))
    got = att.decode_attention(q3 * d ** -0.5, k[0], v[0], kn, vn, 40,
                               head_dim=d)
    want = att.decode_attention_plain(q3 * d ** -0.5, k[0], v[0], kn, vn,
                                      40, d)
    _close(got, want, dict(atol=2.0 ** -8 * float(want.float().abs().max()),
                           rtol=2.0 ** -7))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("cur", [0, 513, 1031, "ragged", "outside"])
def test_cache_row_update_kernel_matches_plain(cuda, dtype, cur):
    layers, b, ctx, c = 24, 8, 1032, 64 if dtype == torch.float32 else 6144
    if cur == "ragged":
        cur = torch.tensor([0, 1, 5, 513, 700, 1000, 1030, 1031],
                           dtype=torch.int32, device="cuda")
    elif cur == "outside":  # rows outside [0, ctx) unwritten on both routes
        cur = torch.tensor([-1, 1, 1032, 513, 5000, 1000, -7, 1031],
                           dtype=torch.int32, device="cuda")
    if dtype == torch.int8:  # the int8 cache's 6144-byte rows
        stack, news = (torch.randint(-127, 128, shape, generator=cuda,
                                     device="cuda", dtype=dtype)
                       for shape in ((layers, b, ctx, c), (layers, b, 1, c)))
    else:
        stack = _randn(cuda, layers, b, ctx, c, dtype=dtype)
        news = _randn(cuda, layers, b, 1, c, dtype=dtype)
    want = cache.cache_row_update_plain(stack.clone(), news, cur)
    before = common.LAUNCHES["cache_row_update"]
    got = cache.cache_row_update(stack, news, cur)
    assert common.LAUNCHES["cache_row_update"] == before + 1
    assert got.data_ptr() == stack.data_ptr()  # in place
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_gpt_cached_decode_matches_full_forward_on_card(cuda):
    """Two layers at the prior's width (6144, 16 heads of 384) in bf16:
    prefill + teacher-forced decode steps (B9, B10) give the logits of the
    full forward (B8). Limits: 2^-4 of the largest logit (bf16 GEMMs at
    other row counts round differently), argmax equal on 90% of positions."""
    from enhancing_tpu_torch.models.stage2 import GPT
    gpt = GPT(vocab_cond_size=1000, vocab_img_size=8192, embed_dim=6144,
              cond_num_tokens=1, img_num_tokens=64, n_heads=16, n_layers=2,
              dtype="bfloat16", device="cuda")
    codes = torch.randint(0, 8192, (2, 64), generator=cuda, device="cuda")
    conds = torch.randint(0, 1000, (2, 1), generator=cuda, device="cuda")
    common.reset_launches()
    with torch.inference_mode():
        full = gpt(codes, conds).float()
        cache_ = gpt.init_cache(2)
        logits, cache_ = gpt.prefill(conds, cache_)
        steps = [logits]
        for step in range(1, 64):
            logits, cache_ = gpt.decode_step(codes[:, step - 1], step, cache_)
            steps.append(logits)
    dec = torch.stack(steps, 1).float()
    torch.cuda.synchronize()
    assert common.LAUNCHES["attention_bnhd"] == 2 + 2
    assert common.LAUNCHES["decode_attention"] == 2 * 63
    assert common.LAUNCHES["cache_row_update"] == 2 * 63
    err = float((dec - full).abs().max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    assert err <= 2.0 ** -4 * float(full.abs().max()), err
    assert agree >= 0.9, agree


# -- int8 serving and the LNFUSE decode ---------------------------------------

def _int8_limits(want):
    """fp32 outputs: 1e-5 of the largest |plain| plus 1e-5 relative, for
    fp32 sums over d in another order; bf16: one bf16 step (2^-8) of
    each output plus 2^-8 of the largest, the sums' order moving a
    rounding boundary."""
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return dict(atol=1e-5 * top, rtol=1e-5)
    return dict(atol=2.0 ** -8 * top, rtol=2.0 ** -8)


def _quantized(gen, n, d):
    return int8.quantize_channelwise(_randn(gen, n, d, scale=0.02))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,n,bias,residual,act", [
    (8, 6144, 6144, True, False, None),       # the decode projection
    (8, 6144, 18432, True, False, None),      # the prefill's fused qkv
    (3, 256, 200, False, True, "sqrelu"),
    (20, 1040, 96, True, True, "gelu")])      # rows past one tile of 8
def test_int8_gemm_kernel_matches_plain(cuda, dtype, m, d, n, bias,
                                        residual, act):
    x = _randn(cuda, m, d, dtype=dtype)
    w_q, scale = _quantized(cuda, n, d)
    b = 0.1 * _randn(cuda, n) if bias else None
    res = _randn(cuda, m, n) if residual else None
    before = common.LAUNCHES["int8_gemm"]
    got = int8.int8_gemm(x, w_q, scale, b, activation=act, residual=res)
    assert common.LAUNCHES["int8_gemm"] == before + 1
    want = int8.int8_gemm_plain(x, w_q, scale, b, res, act)
    _close(got, want, _int8_limits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,n,shift,bias", [
    (8, 6144, 18432, True, True),   # the decode step's qkv
    (8, 6144, 8192, False, False),  # the vocab head
    (5, 512, 136, True, False)])
def test_int8_ln_gemm_kernel_matches_plain(cuda, dtype, m, d, n, shift,
                                           bias):
    x = _randn(cuda, m, d, dtype=dtype, scale=2.0)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    tm = torch.linspace(0, 1, d, device="cuda") if shift else None
    prev = _randn(cuda, m, d, dtype=torch.bfloat16) if shift else None
    w_q, scale = _quantized(cuda, n, d)
    b = 0.1 * _randn(cuda, n, dtype=torch.bfloat16) if bias else None
    before = common.LAUNCHES["int8_ln_gemm"]
    got, xn = int8.int8_ln_gemm(x, gamma, beta, tm, prev, w_q, scale, b)
    assert common.LAUNCHES["int8_ln_gemm"] == before + 1
    want, want_xn = int8.int8_ln_gemm_plain(x, gamma, beta, tm, prev, w_q,
                                            scale, b)
    _close(got, want, _int8_limits(want))
    _close(xn, want_xn, _int8_limits(want_xn))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,h,bias", [(8, 6144, 24576, True),
                                        (3, 256, 1024, False),
                                        (19, 512, 2048, True)])
def test_int8_mlp_kernel_matches_plain(cuda, dtype, m, d, h, bias):
    x = _randn(cuda, m, d, dtype=dtype)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    w0_q, s0 = _quantized(cuda, h, d)
    w1_q, s1 = _quantized(cuda, d, h)
    b0 = 0.1 * _randn(cuda, h) if bias else None
    b1 = 0.1 * _randn(cuda, d) if bias else None
    before = common.LAUNCHES["int8_mlp"]
    got = int8.int8_mlp_decode(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1,
                               residual=x)
    assert common.LAUNCHES["int8_mlp"] == before + 1
    want = int8.int8_mlp_plain(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1,
                               x.float())
    # bf16: the hidden rounds to bf16 before W1; a sum in another order
    # puts some hidden values on the other side of a rounding boundary
    tol = _int8_limits(want)
    if dtype == torch.bfloat16:
        tol = dict(atol=2.0 ** -7 * float(want.float().abs().max()),
                   rtol=2.0 ** -7)
    _close(got, want, tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,d,n,shift", [(8, 6144, 18432, True),
                                         (4, 384, 264, False)])
def test_ln_shift_gemm_kernel_matches_plain(cuda, x_dtype, w_dtype, m, d, n,
                                            shift):
    x = _randn(cuda, m, d, dtype=x_dtype, scale=2.0)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    tm = torch.linspace(0, 1, d, device="cuda") if shift else None
    prev = _randn(cuda, m, d, dtype=torch.bfloat16) if shift else None
    w = _randn(cuda, n, d, dtype=w_dtype, scale=d ** -0.5)
    b = 0.1 * _randn(cuda, n)
    before = common.LAUNCHES["ln_shift_gemm"]
    got, xn = lg.fused_ln_shift_gemm(x, gamma, beta, tm, prev, w, b)
    assert common.LAUNCHES["ln_shift_gemm"] == before + 1
    want, want_xn = lg.ln_shift_gemm_plain(x, gamma, beta, tm, prev, w, b)
    _close(got, want, _int8_limits(want))
    _close(xn, want_xn, _int8_limits(want_xn))


def test_int8_kernels_refuse_autograd_and_odd_shapes(cuda):
    x = _randn(cuda, 8, 256).requires_grad_()
    g, bt = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    w_q, scale = _quantized(cuda, 128, 256)
    with pytest.raises(NotImplementedError):
        int8.int8_gemm(x, w_q, scale)
    with pytest.raises(NotImplementedError):
        int8.int8_ln_gemm(x, g, bt, None, None, w_q, scale)
    with pytest.raises(NotImplementedError):
        lg.fused_ln_shift_gemm(x, g, bt, None, None,
                               _randn(cuda, 128, 256, dtype=torch.bfloat16))
    w1_q, s1 = _quantized(cuda, 256, 128)
    with pytest.raises(NotImplementedError):
        int8.int8_mlp_decode(x, g, bt, w_q, scale, None, w1_q, s1, None,
                             residual=x)
    with pytest.raises(ValueError):  # d % 16
        int8.int8_gemm(_randn(cuda, 8, 200), *_quantized(cuda, 64, 200))


def _int8_stack(gen, layers, b, ctx, hd, cur):
    """An int8 (L, B, ctx, H*D) k and v and their fp32 row scales; rows at
    or past each row's cur_len hold 127 at a scale of 1e6."""
    out = []
    dead = (torch.arange(ctx, device="cuda")[None, :]
            >= torch.as_tensor(cur, device="cuda").reshape(-1, 1))
    for _ in range(2):
        q, sc = int8.quantize_channelwise(_randn(gen, layers, b, ctx, hd))
        q.masked_fill_(dead[None, :, :, None].expand_as(q), 127)
        sc.masked_fill_(dead[None].expand_as(sc), 1e6)
        out += [q, sc]
    return out


@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("cur", [1, 255, 513, 1024, "ragged"])
def test_decode_attention_kernel_mixed_dtypes_match_plain(
        cuda, q_dtype, cache_dtype, cur):
    layers, b, ctx, h, d = 3, 4, 1032, 16, 384
    if cur == "ragged":
        cur = torch.tensor([1, 255, 513, 1024], dtype=torch.int32,
                           device="cuda")
    if cache_dtype == torch.int8:
        k, ks, v, vs = _int8_stack(cuda, layers, b, ctx, h * d, cur)
        new_dtype = q_dtype
    else:
        k, v = _stack(cuda, layers, b, ctx, h * d, cur, cache_dtype)
        ks = vs = None
        new_dtype = cache_dtype
    q3 = _randn(cuda, b, h * d, dtype=q_dtype, scale=d ** -0.5)
    kn, vn = (_randn(cuda, b, h * d, dtype=new_dtype) for _ in range(2))
    before = common.LAUNCHES["decode_attention"]
    got = att.decode_attention_stacked(q3, k, v, kn, vn, cur, 1, head_dim=d,
                                       k_scale=ks, v_scale=vs)
    assert common.LAUNCHES["decode_attention"] == before + 1
    assert got.dtype == q_dtype
    with common.force_plain_ops():
        want = att.decode_attention_stacked(q3, k, v, kn, vn, cur, 1,
                                            head_dim=d, k_scale=ks,
                                            v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # the plain version computes PV in the value dtype it dequantises or
    # reads to (bf16 under a bf16 cache or q) and rounds its unnormalised
    # sum, the kernel sums in fp32: two bf16 steps of the row's largest
    # output
    if torch.bfloat16 in (q_dtype, cache_dtype):
        _row_close(got, want, 2.0 ** -7, 2.0 ** -7)
    else:
        _row_close(got, want, 1e-5, 1e-5)
    # against the same function in fp32 on the same (dequantised) values:
    # another summation order, and one rounding of a bf16 output
    if cache_dtype == torch.int8:
        k32, v32 = att.dequant_cache(k[1], v[1], ks[1], vs[1], torch.float32)
    else:
        k32, v32 = k[1].float(), v[1].float()
    want32 = att.decode_attention_plain(q3.float(), k32, v32, kn.float(),
                                        vn.float(), cur, d)
    if q_dtype == torch.float32:
        _row_close(got, want32, 1e-5, 1e-5)
    else:
        _row_close(got, want32, 2.0 ** -12, 2.0 ** -8)


def test_decode_attention_kernel_refuses_unpaired_dtypes(cuda):
    k, v = _stack(cuda, 1, 2, 64, 128, 10, torch.float32)
    q = _randn(cuda, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # (bf16 q, f32 cache) is no pair
        att.decode_attention_stacked(q, k, v, q, q, 10, 0, head_dim=64)
    kq, vq = k.to(torch.int8), v.to(torch.int8)
    qf = q.float()
    with pytest.raises(ValueError):  # an int8 cache needs its scales
        att.decode_attention_stacked(qf, kq, vq, qf, qf, 10, 0, head_dim=64)


def test_int8_gpt_decode_goes_through_the_int8_kernels(cuda):
    """Two layers at the prior's width, bf16 weights quantised, an int8
    cache: prefill + 8 decode steps launch B12 2 x 2 + 2 x 8, B14 2 + 2 x
    8, B13 1 + 3 x 8, B9 2 x 8, B10 2 x 8, B8 2; the kernels' logits
    against the plain
    path's within 2^-6 of the largest."""
    from enhancing_tpu_torch.models.stage2 import (GPT,
                                                   drop_quantized_kernels,
                                                   quantize_decode_params)
    gpt = GPT(vocab_cond_size=1000, vocab_img_size=8192, embed_dim=6144,
              cond_num_tokens=1, img_num_tokens=16, n_heads=16, n_layers=2,
              dtype="bfloat16", kv_int8=True, device="cuda")
    quantize_decode_params(gpt)
    drop_quantized_kernels(gpt)
    codes = torch.randint(0, 8192, (8, 16), generator=cuda, device="cuda")
    conds = torch.randint(0, 1000, (8, 1), generator=cuda, device="cuda")

    def run():
        with torch.inference_mode():
            cache_ = gpt.init_cache(8)
            logits, cache_ = gpt.prefill(conds, cache_)
            out = [logits]
            for step in range(1, 9):
                logits, cache_ = gpt.decode_step(codes[:, step - 1], step,
                                                 cache_)
                out.append(logits)
        return torch.stack(out, 1).float()

    common.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    assert launches == {"int8_gemm": 20, "int8_mlp": 18, "int8_ln_gemm": 25,
                        "decode_attention": 16, "attention_bnhd": 2,
                        "cache_row_update": 16}, launches
    with common.force_plain_ops():
        want = run()
    err = float((got - want).abs().max())
    assert err <= 2.0 ** -6 * float(want.abs().max()), err
