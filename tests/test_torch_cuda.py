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
from enhancing_tpu_torch.ops import ln_gemm as lg
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
                               "vq": 1}
    assert rec.shape == (3, 32, 32, 3) and torch.isfinite(rec).all()
