"""The attention kernels at fp32 and at head dims between the Hopper
tiles, on the card, against their plain PyTorch versions.

``csrc/attention_f32.cu`` computes the fp32 forward (B2 on the packed qkv
buffer, B8 at head dims up to 128 and at the prior's 384, B17-B19) and
the fp32 backward (B5) on the bf16 tensor cores, each fp32 product as six
products of exact bf16 pieces; the bf16 Hopper kernels run a head dim that
is a multiple of 8 up to 128 on their next tile (D = 48, 80, 96 here).
The opt-in fusions B15 and B16 run fp32 on their fp32 kernels on the same
pieces (``csrc/attn_proj_f32.cu``, ``csrc/ffn_f32.cu``) where their
routes name them, and the unfused form elsewhere. Every test needs an NVIDIA card
and skips without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_attention_f32.py
"""
import pytest
import torch

from enhancing_tpu_torch.ops import attention as att
from enhancing_tpu_torch.ops import common, ffn

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


@pytest.mark.parametrize("b,n,h,mode,cl", [(2, 1025, 2, "prefix_causal", 1),
                                           (1, 77, 2, "none", 0),
                                           (1, 200, 2, "prefix_causal", 70)])
def test_f32_backward_at_384_matches_autograd_of_plain(cuda, b, n, h, mode,
                                                       cl):
    """B5 in fp32 at the prior's head dim (csrc/attention_bwd_wide.cu), on
    the lane slices of a qkv buffer, against autograd of the plain
    version; two calls give the same bits."""
    d = 384
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
    """fp32 D = 192, the backward at 192, fp16, mixed dtypes; the raw
    launches of the opt-in fusions B15 and B16 run fp32 on their fp32
    kernels (the plain versions' results) and refuse mixed dtypes and the
    shapes their plans refuse (D = 80), naming the route that sends those
    calls to the unfused form."""
    with pytest.raises(ValueError, match="head_dim"):
        att.attention_packed_qkv_kernel(_randn(cuda, 1, 16, 3 * 2 * 192), 2,
                                        192, 0.1)
    q3 = _randn(cuda, 1, 16, 2 * 192)
    with pytest.raises(ValueError, match="head_dim"):
        att.attention_bwd_kernel(q3, q3, q3, q3, 2, 192)
    with pytest.raises(TypeError):
        att.attention_packed_qkv_kernel(
            _randn(cuda, 1, 16, 3 * 2 * 64, dtype=torch.float16), 2, 64, 0.1)
    q = _randn(cuda, 1, 16, 2, 64)
    with pytest.raises(TypeError):
        att.attention_bnhd_kernel(q, q.bfloat16(), q, 0.1)
    k = _randn(cuda, 1, 16, 2, 64)
    wp, bp, res = _randn(cuda, 128, 128), _randn(cuda, 128), _randn(cuda, 1,
                                                                     16, 128)
    _close(att.attn_proj_kernel(q, k, k, wp, bp, res, 0.1),
           att.attention_proj_plain(q, k, k, wp, bp, res, 0.1), F32_TOL)
    with pytest.raises(TypeError):
        att.attn_proj_kernel(q, k, k, wp.bfloat16(), bp, res, 0.1)
    for dtype in (torch.bfloat16, torch.float32):
        q80 = _randn(cuda, 1, 16, 2, 80, dtype=dtype)
        with pytest.raises(ValueError, match="attn_proj_route"):
            att.attn_proj_kernel(q80, q80, q80,
                                 _randn(cuda, 128, 160, dtype=dtype), bp,
                                 _randn(cuda, 1, 16, 128, dtype=dtype), 0.1)
    x = _randn(cuda, 8, 128)
    w1, b1 = _randn(cuda, 128, 128) * 0.1, _randn(cuda, 128)
    w2, b2 = _randn(cuda, 128, 128) * 0.1, _randn(cuda, 128)
    _close(ffn.ffn_kernel(x, w1, b1, w2, b2),
           ffn.ffn_plain(x, w1, b1, w2, b2), F32_TOL)
    with pytest.raises(TypeError):
        ffn.ffn_kernel(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="ffn_route"):
        ffn.ffn_kernel(_randn(cuda, 8, 1088), _randn(cuda, 128, 1088),
                       b1, _randn(cuda, 1088, 128), _randn(cuda, 1088))


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


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n,m", [(1, 1), (63, 130), (130, 65), (257, 257)])
def test_f32_wide_forward_ragged(cuda, mode, cl, n, m):
    """attn_f32_wide_kernel (D = 384): B17 at ragged N and M (the scale on
    the fp32 scores) and, at M = N, B8 on (B, N, H, D) (q scaled in
    fp32)."""
    d = 384
    q = _randn(cuda, 2, 2, n, d)
    k, v = _randn(cuda, 2, 2, m, d), _randn(cuda, 2, 2, m, d)
    got = att.multihead_attention(q, k, v, mask_mode=mode, cond_len=cl)
    _close(got, att.attention_plain(q, k, v, d ** -0.5, mode, cl), F32_TOL)
    if n == m:
        qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))
        got = att.multihead_attention_bnhd(qb, kb, vb, mask_mode=mode,
                                           cond_len=cl)
        _close(got, att.attention_bnhd_plain(qb, kb, vb, d ** -0.5, mode,
                                             cl), F32_TOL)


def test_fused_routes_take_fp32_and_heads_of_80(cuda):
    """attention_proj_packed and fused_ffn on the card by their routes:
    one launch of B15 in fp32 at heads of 64 (csrc/attn_proj_f32.cu,
    counted in F32_LAUNCHES) and in bf16 (csrc/attn_proj.cu); the unfused
    form (the B8 kernel, fp32 or bf16, and fp32 library products, counted
    in UNFUSED_CALLS, no launch of B15) where the JAX package computes it
    too: HO off the 128-lane grid, heads of 80. fused_ffn in fp32: B16 up
    to 12 MiB of weights (csrc/ffn_f32.cu), the unfused form above.
    Results those of the plain versions (fp32: F32_TOL; bf16: the
    attention's bf16 limits)."""
    b, n = 2, 77
    for dtype, h, d, ho, route, tol in (
            (torch.float32, 4, 64, 96, "unfused", F32_TOL),
            (torch.float32, 2, 64, 128, "attn_proj", F32_TOL),
            (torch.bfloat16, 2, 80, 96, "unfused", ATTN_TOL),
            (torch.bfloat16, 2, 64, 128, "attn_proj", ATTN_TOL)):
        qkv = _randn(cuda, b, n, 3 * h * d, dtype=dtype)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
        wp = _randn(cuda, ho, h * d) * 0.05
        bp, res = _randn(cuda, ho), _randn(cuda, b, n, ho, dtype=dtype)
        assert att.attn_proj_route(dtype, h, d, ho, n, n) == route
        common.reset_launches()
        with torch.no_grad():
            got = att.attention_proj_packed(q, k, v, wp, bp, res)
        torch.cuda.synchronize()
        fused = route == "attn_proj"
        assert common.UNFUSED_CALLS["attn_proj"] == (0 if fused else 1)
        assert {k: v for k, v in common.LAUNCHES.items() if v} == {
            "attn_proj" if fused else "attention_bnhd": 1}
        assert common.F32_LAUNCHES["attn_proj"] == int(
            fused and dtype == torch.float32)
        want = att.attention_proj_plain(q, k, v, wp.to(dtype), bp, res,
                                        d ** -0.5)
        _close(got, want, tol)
    for d, h, route in ((128, 256, "ffn"), (768, 3072, "unfused")):
        x = _randn(cuda, 2, 50, d)
        w1, b1 = _randn(cuda, h, d) * d ** -0.5, _randn(cuda, h)
        w2, b2 = _randn(cuda, d, h) * h ** -0.5, _randn(cuda, d)
        assert ffn.ffn_route(torch.float32, 100, d, h) == route
        common.reset_launches()
        got = ffn.fused_ffn(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        fused = route == "ffn"
        assert common.UNFUSED_CALLS["ffn"] == (0 if fused else 1)
        assert common.LAUNCHES["ffn"] == common.F32_LAUNCHES["ffn"] == int(
            fused)
        _close(got, ffn.ffn_plain(x.reshape(-1, d), w1, b1, w2,
                                  b2).reshape(x.shape), F32_TOL)


@pytest.mark.parametrize("h,d,ho", [(8, 64, 512), (12, 64, 768),
                                    (16, 64, 1280), (16, 32, 512),
                                    (4, 128, 512), (3, 128, 384)])
@pytest.mark.parametrize("n,m,mode,cl", [(77, 77, "none", 0),
                                         (130, 65, "prefix_causal", 5),
                                         (17, 130, "prefix_causal", 70)])
def test_attn_proj_f32_kernel_matches_plain(cuda, h, d, ho, n, m, mode, cl):
    """fp32 B15 (csrc/attn_proj_f32.cu) at head dims 32, 64 and 128, the
    shipped towers' (H*D, HO), odd N and M, both masks, q, k and v lane
    slices of wider buffers: against the plain version at F32_TOL, one
    launch counted under attn_proj and in F32_LAUNCHES."""
    hd = h * d
    q = _randn(cuda, 2, n, 2 * hd)[..., :hd].unflatten(-1, (h, d))
    k, v = (t.unflatten(-1, (h, d))
            for t in _randn(cuda, 2, m, 2 * hd).chunk(2, -1))
    wp = _randn(cuda, ho, hd) * (2.0 / (hd + ho)) ** 0.5
    bp, res = _randn(cuda, ho) * 0.02, _randn(cuda, 2, n, ho)
    common.reset_launches()
    got = att.attn_proj_kernel(q, k, v, wp, bp, res, d ** -0.5, mode, cl)
    torch.cuda.synchronize()
    assert common.LAUNCHES["attn_proj"] == common.F32_LAUNCHES[
        "attn_proj"] == 1
    _close(got, att.attention_proj_plain(q, k, v, wp, bp, res, d ** -0.5,
                                         mode, cl), F32_TOL)


@pytest.mark.parametrize("m,d,h", [(8192, 512, 2048), (1000, 768, 2048),
                                   (333, 256, 1088), (129, 64, 256),
                                   (200, 1024, 1024)])
@pytest.mark.parametrize("act", ["tanh", "sqrelu", "gelu"])
def test_ffn_f32_kernel_matches_plain(cuda, m, d, h, act):
    """fp32 B16 (csrc/ffn_f32.cu): clusters of 4 (ViT-VQGAN-Small's
    shape), 6, 2 with a short last hidden group, 1 with a 64-column slab,
    and 8, against the plain version at F32_TOL."""
    sc = (2.0 / (d + h)) ** 0.5
    x, w1, b1 = _randn(cuda, m, d), _randn(cuda, h, d) * sc, _randn(cuda, h)
    w2, b2 = _randn(cuda, d, h) * sc, _randn(cuda, d)
    common.reset_launches()
    got = ffn.ffn_kernel(x, w1, b1 * 0.02, w2, b2 * 0.02, act)
    torch.cuda.synchronize()
    assert common.LAUNCHES["ffn"] == common.F32_LAUNCHES["ffn"] == 1
    _close(got, ffn.ffn_plain(x, w1, b1 * 0.02, w2, b2 * 0.02, act), F32_TOL)


def test_f32_fusions_are_deterministic(cuda):
    """No atomics in fp32 B15 and B16: two calls give the same bits."""
    q = _randn(cuda, 2, 100, 12, 64)
    k, v = _randn(cuda, 2, 100, 12, 64), _randn(cuda, 2, 100, 12, 64)
    wp, bp, res = _randn(cuda, 768, 768) * 0.04, _randn(cuda, 768), _randn(
        cuda, 2, 100, 768)
    assert torch.equal(att.attn_proj_kernel(q, k, v, wp, bp, res, 0.125),
                       att.attn_proj_kernel(q, k, v, wp, bp, res, 0.125))
    x, w1, w2 = (_randn(cuda, 300, 512), _randn(cuda, 2048, 512) * 0.03,
                 _randn(cuda, 512, 2048) * 0.03)
    b1, b2 = _randn(cuda, 2048), _randn(cuda, 512)
    assert torch.equal(ffn.ffn_kernel(x, w1, b1, w2, b2),
                       ffn.ffn_kernel(x, w1, b1, w2, b2))


def test_f32_fusion_plans_mirror_the_c_entries(cuda):
    """ops.attention.attn_proj_f32_plan and ops.ffn.ffn_f32_plan give the
    numbers csrc/attn_proj_f32.cu and csrc/ffn_f32.cu pick, and zeros
    where the mirrors refuse."""
    from enhancing_tpu_torch.ops import cuda_lib
    for h, d, ho in ((8, 64, 512), (12, 64, 768), (16, 64, 1280),
                     (16, 32, 512), (24, 32, 768), (4, 128, 512),
                     (2, 64, 128), (12, 128, 1536), (4, 80, 512),
                     (4, 64, 96)):
        want = att.attn_proj_f32_plan(h, d, ho)
        got = cuda_lib.plan("etk_attn_proj_f32_plan", h, d, ho, size=5)
        assert got == ((0,) * 5 if want is None else (
            want["cluster"], want["heads_per_wg"], want["stages"],
            want["smem"], want["warpgroups"])), (h, d, ho)
    for d in (64, 128, 512, 640, 1024, 1088, 96):
        want = ffn.ffn_f32_plan(d)
        got = cuda_lib.plan("etk_ffn_f32_plan", d, size=5)
        assert got == ((0,) * 5 if want is None else (
            want["cluster"], want["slab"], want["chunk"], want["stages"],
            want["smem"])), d


def test_f32_fused_round_trip_goes_through_the_fusions(cuda):
    """A tiny fp32 tokenizer with both fusions (``ffn_impl: fused``,
    ENHANCING_TPU_ATTN_PROJ=1) on the 128-lane grid: every block runs fp32
    B15 and fp32 B16 (B1 2, B15 2, B3 4, B16 2, B4 1 a trip, no unfused
    call), and the round trip agrees with the same model's plain path."""
    import os

    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    tower = dict(dim=128, depth=1, heads=4, dim_head=32, mlp_dim=512,
                 ffn_impl="fused")
    model = ViTVQ(image_size=32, patch_size=8, encoder=tower, decoder=tower,
                  quantizer=dict(embed_dim=16, n_embed=128), device="cuda")
    x = torch.rand(3, 32, 32, 3, generator=cuda, device="cuda")
    saved = os.environ.get("ENHANCING_TPU_ATTN_PROJ")
    os.environ["ENHANCING_TPU_ATTN_PROJ"] = "1"
    try:
        common.reset_launches()
        codes = model.encode_codes(x)
        rec = model.decode_codes(codes)
        torch.cuda.synchronize()
        assert {k: v for k, v in common.LAUNCHES.items() if v} == {
            "ln_gemm": 2, "attn_proj": 2, "layernorm": 4, "ffn": 2, "vq": 1}
        assert {k: v for k, v in common.F32_LAUNCHES.items() if v} == {
            "attn_proj": 2, "ffn": 2}
        assert not any(common.UNFUSED_CALLS.values())
        with common.force_plain_ops():
            codes_p = model.encode_codes(x)
            rec_p = model.decode_codes(codes)
    finally:
        if saved is None:
            os.environ.pop("ENHANCING_TPU_ATTN_PROJ", None)
        else:
            os.environ["ENHANCING_TPU_ATTN_PROJ"] = saved
    assert torch.equal(codes, codes_p)
    _close(rec, rec_p, dict(atol=1e-4, rtol=1e-4))
