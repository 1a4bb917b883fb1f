"""The attention kernels at fp32 and at head dims between the Hopper
tiles, on the card, against their plain PyTorch versions.

``csrc/attention_f32.cu`` computes the fp32 forward (B2 on the packed qkv
buffer, B8 at head dims up to 128 and at the prior's 384, B17-B19) and
the fp32 backward (B5); the bf16 Hopper kernels run a head dim that is a
multiple of 8 up to 128 on their next tile (D = 48, 80, 96 here). Every
test needs an NVIDIA card and skips without one. The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_attention_f32.py
"""
import pytest
import torch

from enhancing_tpu_torch.ops import attention as att
from enhancing_tpu_torch.ops import common

pytestmark = pytest.mark.cuda

# fp32: sums in another order (tests/test_torch_cuda.py's F32_TOL); the
# backward's terms sum over N keys or queries: 1e-4 absolute and relative
F32_TOL = dict(atol=1e-4, rtol=1e-5)
F32_BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16: P rounds to bf16 against the running row max in the kernel
ATTN_TOL = dict(atol=1e-2, rtol=2.0 ** -7)
HEAD_DIMS = [32, 48, 64, 80, 96, 128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("n,mode,cl", [(1, "none", 0), (65, "prefix_causal", 3),
                                       (130, "none", 0),
                                       (1025, "prefix_causal", 5)])
def test_f32_packed_qkv_forward(cuda, d, n, mode, cl):
    """B2 in fp32: one launch of the fp32 kernel, counted under
    'attention' with the bf16 launches and in F32_LAUNCHES."""
    b, h = 2, 3
    qkv = _randn(cuda, b, n, 3 * h * d)
    before = (common.LAUNCHES["attention"], common.F32_LAUNCHES["attention"])
    got = att.multihead_attention_packed_qkv(qkv, h, d, mask_mode=mode,
                                             cond_len=cl)
    assert (common.LAUNCHES["attention"],
            common.F32_LAUNCHES["attention"]) == (before[0] + 1,
                                                  before[1] + 1)
    _close(got, att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode,
                                               cl), F32_TOL)


@pytest.mark.parametrize("b,n,h,d,cl", [(8, 1025, 16, 384, 1),
                                        (8, 1, 16, 384, 1),
                                        (2, 130, 2, 384, 3),
                                        (8, 1025, 16, 64, 1)])
def test_f32_bnhd_forward_at_the_prior_shapes(cuda, b, n, h, d, cl):
    """B8 in fp32 on the lane slices of a qkv buffer: the prior's prefill
    (N = 1025 teacher-forced, N = 1 sampling) at 16 heads of 384."""
    qkv = _randn(cuda, b, n, 3 * h * d)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    got = att.multihead_attention_bnhd(q, k, v, mask_mode="prefix_causal",
                                       cond_len=cl)
    _close(got, att.attention_bnhd_plain(q, k, v, d ** -0.5, "prefix_causal",
                                         cl), F32_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n,m", [(1, 1), (63, 63), (65, 130), (130, 65)])
def test_f32_score_scale_forwards(cuda, d, mode, cl, n, m):
    """B17 ((B, H, N, D)) and, at M = N, B18 ((B, N, H, D)): the scale on
    the fp32 scores."""
    q = _randn(cuda, 2, 2, n, d)
    k, v = _randn(cuda, 2, 2, m, d), _randn(cuda, 2, 2, m, d)
    scale = d ** -0.5
    got = att.multihead_attention(q, k, v, mask_mode=mode, cond_len=cl)
    _close(got, att.attention_plain(q, k, v, scale, mode, cl), F32_TOL)
    if n == m:
        qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = att._attention_fused_bnhd(qb, kb, vb, scale, mode, cl)
        _close(got, att.attention_fused_bnhd_plain(qb, kb, vb, scale, mode,
                                                   cl), F32_TOL)


@pytest.mark.parametrize("d", [64, 80, 384])
def test_f32_gridchunk_forward(cuda, d):
    """B19 in fp32: prefix-causal on pre-scaled packed q, k, v."""
    b, n, h = 2, 257, 2
    q3, k3, v3 = (_randn(cuda, b, n, h * d) for _ in range(3))
    got = att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal", 1, d)
    _close(got, att.attention_packed_plain(q3, k3, v3, "prefix_causal", 1,
                                           d), F32_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,n,h,mode,cl", [(2, 1025, 2, "prefix_causal", 5),
                                           (1, 64, 3, "none", 0),
                                           (2, 77, 2, "none", 0),
                                           (1, 1, 2, "prefix_causal", 1)])
def test_f32_backward_matches_autograd_of_plain(cuda, d, b, n, h, mode, cl):
    """B5 in fp32 on the lane slices of a qkv buffer, against autograd of
    the plain version; two calls give the same bits."""
    qkv = _randn(cuda, b, n, 3 * h * d)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = _randn(cuda, b, n, h * d)
    got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    again = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
    for g, a, w in zip(got, again, want):
        _close(g, w, F32_BWD_TOL)
        assert torch.equal(g, a)


def test_f32_autograd_goes_through_both_kernels(cuda):
    """The fp32 tokenizer's attention under autograd: forward and backward
    each one fp32 launch, gradients those of the plain version."""
    b, n, h, d = 2, 100, 2, 80
    qkv = _randn(cuda, b, n, 3 * h * d).requires_grad_()
    g = _randn(cuda, b, n, h * d)
    common.reset_launches()
    out = att.multihead_attention_packed_qkv(qkv, h, d)
    (grad,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert {k: v for k, v in common.F32_LAUNCHES.items() if v} == {
        "attention": 1, "attention_bwd": 1}
    leaf = qkv.detach().requires_grad_()
    want = att.attention_packed_qkv_plain(leaf, h, d, d ** -0.5)
    (want_grad,) = torch.autograd.grad(want, leaf, g)
    _close(out, want, F32_TOL)
    _close(grad, want_grad, F32_BWD_TOL)


@pytest.mark.parametrize("d", [48, 80, 96])
@pytest.mark.parametrize("b,n,h,mode,cl", [(2, 1025, 3, "prefix_causal", 5),
                                           (8, 1024, 16, "none", 0),
                                           (2, 65, 2, "none", 0)])
def test_bf16_head_dims_between_the_tiles(cuda, d, b, n, h, mode, cl):
    """bf16 forward (B2 and B8 on the same lane slices, bit-equal) and
    backward at head dims that run on the next tile."""
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    got = att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5, mode, cl)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    strided = att.attention_bnhd_kernel(q, k, v, d ** -0.5, mode, cl)
    torch.cuda.synchronize()
    assert torch.equal(got, strided.view(b, n, h * d))
    _close(got, att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode,
                                               cl), ATTN_TOL)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = _randn(cuda, b, n, h * d, dtype=torch.bfloat16)
    grads = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    for g, w in zip(grads, att.attention_bwd_plain(q3, k3, v3, do, h, d,
                                                   mode, cl)):
        _close(g, w, dict(atol=2.0 ** -6 * float(w.float().abs().max()),
                          rtol=2.0 ** -6))


def test_f32_kernels_refuse_what_they_do_not_take(cuda):
    """fp32 D = 192, the backward at 384, fp16, mixed dtypes; fp32 and
    D = 80 under the opt-in fusions B15 and B16 (ROADMAP.md C1)."""
    from enhancing_tpu_torch.ops import ffn
    with pytest.raises(ValueError, match="head_dim"):
        att.attention_packed_qkv_kernel(_randn(cuda, 1, 16, 3 * 2 * 192), 2,
                                        192, 0.1)
    q3 = _randn(cuda, 1, 16, 2 * 384)
    with pytest.raises(ValueError, match="head_dim"):
        att.attention_bwd_kernel(q3, q3, q3, q3, 2, 384)
    with pytest.raises(TypeError):
        att.attention_packed_qkv_kernel(
            _randn(cuda, 1, 16, 3 * 2 * 64, dtype=torch.float16), 2, 64, 0.1)
    q = _randn(cuda, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        att.attention_bnhd_kernel(q, q.bfloat16(), q, 0.1)
    k = _randn(cuda, 1, 16, 2, 64)
    wp, bp, res = _randn(cuda, 128, 128), _randn(cuda, 128), _randn(cuda, 1,
                                                                     16, 128)
    with pytest.raises(TypeError, match="C1"):
        att.attn_proj_kernel(q, k, k, wp, bp, res, 0.1)
    q80 = _randn(cuda, 1, 16, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C1"):
        att.attn_proj_kernel(q80, q80, q80,
                             _randn(cuda, 128, 160, dtype=torch.bfloat16),
                             bp, _randn(cuda, 1, 16, 128,
                                        dtype=torch.bfloat16), 0.1)
    x = _randn(cuda, 8, 128)
    with pytest.raises(TypeError, match="C1"):
        ffn.ffn_kernel(x, _randn(cuda, 128, 128), _randn(cuda, 128),
                       _randn(cuda, 128, 128), _randn(cuda, 128))


@pytest.mark.parametrize("dec_head", [64, 80])
def test_f32_tiny_round_trip_matches_the_plain_path(cuda, dec_head):
    """An fp32 tokenizer with towers of other widths (the decoder's heads
    64 or 80 wide): the round trip goes through the kernels (B1 8, B2 4,
    B3 2, B4 1, every attention launch fp32) and agrees with the same
    model's plain path (force_plain_ops)."""
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    enc = dict(dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
    dec = dict(dim=160, depth=2, heads=2, mlp_dim=320, dim_head=dec_head)
    model = ViTVQ(image_size=32, patch_size=8, encoder=enc, decoder=dec,
                  quantizer=dict(embed_dim=16, n_embed=128), device="cuda")
    x = torch.rand(3, 32, 32, 3, generator=cuda, device="cuda")
    common.reset_launches()
    codes = model.encode_codes(x)
    rec = model.decode_codes(codes)
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "ln_gemm": 8, "attention": 4, "layernorm": 2, "vq": 1}
    assert common.F32_LAUNCHES["attention"] == 4
    with common.force_plain_ops():
        codes_p = model.encode_codes(x)
        rec_p = model.decode_codes(codes)
    assert torch.equal(codes, codes_p)
    _close(rec, rec_p, dict(atol=1e-4, rtol=1e-4))
