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
from enhancing_tpu_torch.ops import common
from enhancing_tpu_torch.ops import fused_act as fa
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
                               "fused_act": 0}
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
                               "fir": 18, "fused_act": 27}
    assert {k: v for k, v in common.PLAIN_CALLS.items() if v} == {
        "fir": 6, "fused_act": 9}
    assert all(torch.isfinite(v).all() for v in log.values()), log
