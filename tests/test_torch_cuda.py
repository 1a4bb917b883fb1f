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
from enhancing_tpu_torch.ops import ffn
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


@pytest.mark.parametrize("activation", [None, "tanh", "sqrelu", "gelu"])
@pytest.mark.parametrize("d", [32, 768, 1280])
@pytest.mark.parametrize("n", [8, 136, 2304, 2312])
@pytest.mark.parametrize("m", [1, 100, 1000, 8192])
def test_ln_gemm_wgmma_tiles_match_plain(cuda, m, n, d, activation):
    """The bf16 wgmma path over its tile edges: m from 1 to several 128-row
    blocks (ragged), n below, at and past 128- and 256-column tiles, d with
    a half k tile (32) and whole ones; a bias with every activation but
    none."""
    x = _randn(cuda, m, d, dtype=torch.bfloat16, scale=2.0)
    gamma = 1.0 + 0.1 * _randn(cuda, d)
    beta = 0.1 * _randn(cuda, d)
    w = _randn(cuda, n, d, dtype=torch.bfloat16, scale=d ** -0.5)
    b = None if activation is None else 0.1 * _randn(cuda, n)
    got = lg.fused_ln_gemm(x, gamma, beta, w, b, activation=activation)
    _close(got, lg.ln_gemm_plain(x, gamma, beta, w, b, activation), BF16_TOL)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("d", [96, 1280])
@pytest.mark.parametrize("n", [136, 2312])
@pytest.mark.parametrize("m", [lg.LN_GEMM_DECODE_ROWS + 1, 1000])
def test_ln_gemm_f32_tiles_match_plain(cuda, m, n, d, activation, w_dtype):
    """csrc/ln_gemm_f32.cu over its tile edges: m just past the decode
    route and past a 128-row block, n past 128-column tiles, d with a
    ragged last 64 k (96) and whole ones; fp32 W (split into pieces) and
    bf16 W (read as stored), a bias with gelu."""
    x = _randn(cuda, m, d, scale=2.0)
    gamma = 1.0 + 0.1 * _randn(cuda, d)
    beta = 0.1 * _randn(cuda, d)
    w = _randn(cuda, n, d, dtype=w_dtype, scale=d ** -0.5)
    b = None if activation is None else 0.1 * _randn(cuda, n)
    assert lg.ln_gemm_route(m, x.dtype, w.dtype) == "f32"
    got = lg.fused_ln_gemm(x, gamma, beta, w, b, activation=activation)
    again = lg.fused_ln_gemm(x, gamma, beta, w, b, activation=activation)
    _close(got, lg.ln_gemm_plain(x, gamma, beta, w, b, activation), F32_TOL)
    assert torch.equal(got, again)


def test_ln_gemm_f32_and_b11_plans_mirror_the_c_entries(cuda):
    """ops.ln_gemm.ln_gemm_f32_plan and ops.ln_gemm.ln_shift_gemm_plan give
    the numbers that csrc/ln_gemm_f32.cu and csrc/ln_shift_gemm.cu pick on
    this card, and both refuse what the Python plans refuse."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (17, 1000, 8192):
        for d, n in ((512, 1536), (768, 2304), (1280, 5120), (96, 136)):
            for pieces in (1, 3):
                want = lg.ln_gemm_f32_plan(m, d, n, pieces, sms)
                assert cuda_lib.plan("etk_ln_gemm_f32_plan", m, d, n, pieces,
                                     size=6) == tuple(
                    want[k] for k in ("tile_m", "tile_n", "tile_k", "stages",
                                      "smem", "grid"))
    keys = ("grid", "row_tiles", "groups", "splits", "split_chunks",
            "stages", "smem", "part_bytes", "sync_words")
    f32, bf16 = torch.float32, torch.bfloat16
    for m, d, n in ((1, 6144, 18432), (8, 6144, 24576), (32, 6144, 8192),
                    (4, 384, 264), (13, 1040, 1000)):
        for x_dtype, w_dtype in ((f32, bf16), (bf16, bf16), (f32, f32)):
            want = lg.ln_shift_gemm_plan(m, d, n, x_dtype, w_dtype, sms)
            pieces = 3 if x_dtype == f32 else 1
            assert cuda_lib.plan("etk_ln_shift_gemm_plan", m, d, n, pieces,
                                 w_dtype.itemsize, size=9) == tuple(
                want[k] for k in keys)
    with pytest.raises(RuntimeError):
        cuda_lib.plan("etk_ln_gemm_f32_plan", 8, 760, 64, 3, size=6)
    with pytest.raises(RuntimeError):
        cuda_lib.plan("etk_ln_shift_gemm_plan", 8, 6144, 64, 3, 1, size=9)


def test_kernel_plans_mirror_the_c_entries(cuda):
    """ops.ln_gemm.ln_gemm_plan and ops.ffn.ffn_plan give the numbers that
    the kernels' own host code picks on this card."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (1, 100, 1024, 8192, 131072):
        for n in (8, 136, 2304, 3072):
            want = lg.ln_gemm_plan(m, n, sms)
            assert cuda_lib.plan("etk_ln_gemm_plan", m, n) == tuple(
                want[k] for k in ("tile_m", "tile_n", "stages", "smem",
                                  "grid"))
    for d in range(64, 2049, 64):
        want = ffn.ffn_plan(d)
        assert cuda_lib.plan("etk_ffn_plan", d, size=6) == tuple(
            want[k] for k in ("cluster", "slab", "chunk", "buffers",
                              "stages", "smem"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(37, 768), (4096, 768), (5, 64)])
def test_layernorm_kernel_matches_plain(cuda, dtype, m, d):
    x = _randn(cuda, m, d, dtype=dtype, scale=3.0) + 1.0
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    got = lg.fused_layernorm(x, gamma, beta)
    want = lg.layernorm(x, gamma, beta)
    _close(got, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


# csrc/layernorm.cu at d = 768: 8-row tiles (bf16 and fp32), a grid of up to
# two blocks an SM, each block a contiguous run of tiles
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 9, 100, 264 * 8 * 3 + 5])
def test_layernorm_streaming_kernel_ragged_rows(cuda, dtype, m):
    """m = 1, a tile less and more one row, fewer tiles than the grid, and
    runs of tiles that the grid does not divide, the last tile ragged; two
    calls bit-equal."""
    d = 768
    x = _randn(cuda, m, d, dtype=dtype, scale=3.0) + 1.0
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    got = lg.layernorm_kernel(x, gamma, beta)
    again = lg.layernorm_kernel(x, gamma, beta)
    want = lg.layernorm(x, gamma, beta)
    _close(got, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
    assert torch.equal(got, again)


def test_layernorm_plan_mirrors_the_c_entry(cuda):
    """ops.ln_gemm.layernorm_plan gives the numbers csrc/layernorm.cu picks
    on this card, and both refuse the same shapes."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (1, 9, 100, 131072):
        for d, item in ((768, 2), (768, 4), (64, 2), (2048, 4), (8, 2)):
            want = lg.layernorm_plan(m, d, item, sms)
            assert cuda_lib.plan("etk_layernorm_plan", m, d, item,
                                 size=4) == tuple(
                want[k] for k in ("rows", "stages", "smem", "grid"))
    for m, d, item in ((0, 768, 2), (8, 772, 2), (8, 2056, 4)):
        with pytest.raises(ValueError):
            lg.layernorm_plan(m, d, item, sms)
        with pytest.raises(RuntimeError):
            cuda_lib.plan("etk_layernorm_plan", m, d, item, size=4)


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
    """A head dim between the tiles (bf16 48) and fp32 now compute: held
    to the plain version. Still refused: D = 192 and fp16."""
    qkv = _randn(cuda, 1, 16, 3 * 2 * 48, dtype=torch.bfloat16)
    _close(att.multihead_attention_packed_qkv(qkv, 2, 48),
           att.attention_packed_qkv_plain(qkv, 2, 48, 48 ** -0.5), ATTN_TOL)
    qkv = _randn(cuda, 1, 16, 3 * 2 * 64)
    _close(att.multihead_attention_packed_qkv(qkv, 2, 64),
           att.attention_packed_qkv_plain(qkv, 2, 64, 0.125), F32_TOL)
    with pytest.raises(ValueError):
        att.multihead_attention_packed_qkv(
            _randn(cuda, 1, 16, 3 * 2 * 192, dtype=torch.bfloat16), 2, 192)
    with pytest.raises(TypeError):
        att.multihead_attention_packed_qkv(
            _randn(cuda, 1, 16, 3 * 2 * 64, dtype=torch.float16), 2, 64)


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


def _near_ties(z, cb):
    """Rows whose two best plain scores lie within 1e-5 relative
    (chip_smoke.py's rule)."""
    scores = -2.0 * (z @ cb.t()) + (cb * cb).sum(-1)[None]
    best2 = torch.topk(scores, 2, dim=-1, largest=False).values
    return best2[:, 1] - best2[:, 0] <= 1e-5 * best2[:, 0].abs().clamp(
        min=1e-6)


@pytest.mark.parametrize("d", vq.KERNEL_DIMS)
@pytest.mark.parametrize("n", [8192, 8191, 100])
@pytest.mark.parametrize("m", [64, 8192, 131072 + 37])
def test_vq_pieces_kernel_outside_near_ties(cuda, m, n, d):
    """csrc/vq.cu on exact bf16 pieces: every row's code is the plain
    version's but where the two best plain scores tie within 1e-5; one
    launch a call. 131 109 rows take two row tiles a warpgroup and a
    ragged last block; 8191 and 100 codes a ragged last stage."""
    z = torch.nn.functional.normalize(_randn(cuda, m, d), dim=-1)
    cb = torch.nn.functional.normalize(_randn(cuda, n, d), dim=-1)
    before = common.LAUNCHES["vq"]
    got = vq.nearest_codebook_indices(z, cb)
    assert common.LAUNCHES["vq"] == before + 1
    want = vq.nearest_plain(z, cb)
    assert got.dtype == torch.int32 and bool(((got >= 0) & (got < n)).all())
    assert not bool(((got != want) & ~_near_ties(z, cb)).any())


@pytest.mark.parametrize("d", vq.KERNEL_DIMS)
@pytest.mark.parametrize("m", [1000, 131072])
def test_vq_pieces_kernel_duplicated_codes_go_to_the_lowest_index(cuda, m, d):
    base = torch.nn.functional.normalize(_randn(cuda, 300, d), dim=-1)
    cb = torch.cat([base, base, base])
    z = base[torch.randint(0, 300, (m,), generator=cuda, device="cuda")]
    got = vq.nearest_codebook_indices(z, cb)
    assert torch.equal(got, vq.nearest_plain(z, cb))
    assert bool((got < 300).all())


def test_vq_plan_mirrors_the_c_entry(cuda):
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (1, 64, 8192, 33792, 33793, 131072, 131109):
        for n, d in ((8192, 32), (8191, 64), (100, 16)):
            got = cuda_lib.plan("etk_vq_plan", m, n, d, size=6)
            assert got == tuple(vq.vq_plan(m, n, d, sms).values())


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
                               "fir_vjp": 0, "fused_act": 0,
                               "attention_bnhd": 0,
                               "decode_attention": 0, "cache_row_update": 0,
                               "ln_shift_gemm": 0, "int8_gemm": 0,
                               "int8_ln_gemm": 0, "int8_mlp": 0,
                               "attn_proj": 0, "ffn": 0,
                               "attention_bhnd": 0,
                               "attention_fused_bnhd": 0,
                               "attention_gridchunk": 0}
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
    (2, 1025, 2, 384, "prefix_causal", 1),
    (1, 77, 2, 384, "none", 0),
    (1, 200, 2, 384, "prefix_causal", 70),
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 384])
def test_bnhd_autograd_goes_through_b8_and_b5(cuda, d, dtype):
    """multihead_attention_bnhd under autograd: one B8 and one B5 launch
    (at 384 csrc/attention_bwd_wide.cu's), gradients against autograd of
    the plain version; fp32 to 1e-4 + 1e-4 relative (the fp32 backward's
    limit, tests/test_torch_attention_f32.py), bf16 to _grad_close."""
    q, k, v, do = (_randn(cuda, 2, 130, 2, d, dtype=dtype) for _ in range(4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    common.reset_launches()
    out = att.multihead_attention_bnhd(*leaves, mask_mode="prefix_causal",
                                       cond_len=1)
    got = torch.autograd.grad(out, leaves, do)
    assert common.LAUNCHES["attention_bnhd"] == 1
    assert common.LAUNCHES["attention_bwd"] == 1
    assert sum(common.WIDE_LAUNCHES.values()) == (d == 384)
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    out_p = att.attention_bnhd_plain(*ref, d ** -0.5, "prefix_causal", 1)
    want = torch.autograd.grad(out_p, ref, do)
    for name, g, w in zip("qkv", got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            _grad_close(g, w, "d" + name)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_wgmma_operand_layouts_match_matmul(cuda, mode):
    """One lone wgmma per operand layout the attention kernels add to the
    GEMMs' (csrc/wgmma_probe.cu): B MN-major with 128-byte rows (P V, dq,
    dk, dv at D 64 and 128) and 64-byte rows (D 32), SS K-major with
    64-byte rows (S at D 32) and RS with B K-major (B15's S). bf16
    products summed in fp32 over 64 (or 32) terms: the same sum in
    another order."""
    from enhancing_tpu_torch.ops import cuda_lib
    k = 32 if mode == 2 else 64
    n = 32 if mode == 1 else 64
    a = _randn(cuda, 64, k, dtype=torch.bfloat16)
    b = _randn(cuda, n if mode >= 2 else k, k if mode >= 2 else n,
               dtype=torch.bfloat16)
    c = torch.empty(64, n, device="cuda")
    cuda_lib.call("etk_wgmma_probe", a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), mode, cuda_lib.stream())
    want = a.float() @ (b.float().t() if mode >= 2 else b.float())
    _close(c, want, dict(atol=1e-4, rtol=1e-5))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 5)])
@pytest.mark.parametrize("n", [1, 63, 64, 1025])
def test_attention_bwd_kernel_head_dims_and_lengths(cuda, d, mode, cl, n):
    """B5 at every head dim the wrapper takes, both masks, and lengths
    below, at and past a tile, under chip_smoke's phase-3 limits."""
    b, h = 2, 2
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = _randn(cuda, b, n, h * d, dtype=torch.bfloat16)
    got = att.attention_bwd_kernel(q3, k3, v3, do, h, d, mode, cl)
    want = att.attention_bwd_plain(q3, k3, v3, do, h, d, mode, cl)
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all()
        _grad_close(g, w, "d" + name)


def test_attention_bwd_kernel_is_deterministic(cuda):
    """No atomics: two launches on the same inputs are bit-equal."""
    b, n, h, d = 2, 1025, 4, 64
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    q3, k3, v3 = att.split_qkv_scaled(qkv, d ** -0.5)
    do = _randn(cuda, b, n, h * d, dtype=torch.bfloat16)
    first = att.attention_bwd_kernel(q3, k3, v3, do, h, d)
    second = att.attention_bwd_kernel(q3, k3, v3, do, h, d)
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("mode,cl", [("prefix_causal", 1), ("none", 0)])
def test_attention_wide_forward_repeats_bit_for_bit(cuda, mode, cl):
    """bf16 B8 at head dim 384 (attn_wide_kernel) on the same inputs, 200
    times: every call's output equal to the first bit for bit. Its S
    warpgroup waits on each key tile's V boxes before it hands P over, so
    no ring wait passes on a load still in flight; the fp32 twin once gave
    other bits in about one call of 200 without that wait."""
    q, k, v = (_randn(cuda, 4, 1025, 16, 384, dtype=torch.bfloat16)
               for _ in range(3))
    first = att.attention_bnhd_kernel(q, k, v, 384 ** -0.5, mode, cl)
    differ = sum(not torch.equal(first, att.attention_bnhd_kernel(
        q, k, v, 384 ** -0.5, mode, cl)) for _ in range(200))
    assert differ == 0


@pytest.mark.parametrize("b,n,h,ho,mode,cl", [
    (8, 1024, 12, 768, "none", 0),           # the fused trip's, batch 8
    (2, 1025, 12, 768, "prefix_causal", 5),  # ragged, prefix-causal
    (1, 1024, 16, 1280, "none", 0),          # imagenet_vitvq_large's decoder
    (2, 1, 12, 768, "none", 0),              # one token
])
def test_attn_proj_kernel_at_the_smoke_shapes(cuda, b, n, h, ho, mode, cl):
    """B15 at chip_smoke's phase-3 shapes and N = 1, under its limits."""
    q, k, v, wp, bp, res = _proj_operands(cuda, b, n, h, ho)
    got = att.attn_proj_kernel(q, k, v, wp, bp, res, 0.125, mode, cl)
    want = att.attention_proj_plain(q, k, v, wp, bp, res, 0.125, mode, cl)
    _row_close(got.view(-1, ho), want.view(-1, ho), 2.0 ** -8, 2.0 ** -7)


def test_attn_proj_plan_mirrors_the_c_entry(cuda):
    """ops.attention.attn_proj_plan gives the numbers csrc/attn_proj.cu
    picks, and refuses the widths whose plan has fewer than two stages."""
    from enhancing_tpu_torch.ops import cuda_lib
    for heads in range(1, 25):
        got = cuda_lib.plan("etk_attn_proj_plan", heads * 64, size=4)
        want = att.attn_proj_plan(heads, 64, 768)
        if want is None:
            assert got[2] < 2
        else:
            assert got == tuple(want[k] for k in ("rows", "chunk", "stages",
                                                  "smem"))


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


@pytest.mark.parametrize("shape", BLUR_SHAPES)
@pytest.mark.parametrize("pad", [(2, 2), (1, 1)])
def test_fir_kernel_bf16_at_the_discriminator_shapes(cuda, shape, pad):
    x = _randn(cuda, *shape, dtype=torch.bfloat16)
    k = fir.make_blur_kernel([1, 3, 3, 1])
    got = fir.upfirdn2d(x, k, pad=pad)
    want = fir.upfirdn2d_plain(x, k, 1, 1, pad)
    assert got.dtype == torch.bfloat16
    # one rounding of an fp32 sum on each side
    _close(got, want, dict(atol=2.0 ** -7, rtol=2.0 ** -7))


_K23 = [[1.0, 2.0, 0.0], [0.5, -1.0, 3.0]]
VJP_CASES = ([(shape, pad, None) for shape in BLUR_SHAPES
              for pad in ((2, 2), (1, 1))]
             + [((2, 19, 23, 64), pad, _K23)
                for pad in ((-1, 2, 0, -2), (3, 0, 1, 1), (0, 0, 0, 0))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad,taps", VJP_CASES)
def test_fir_vjp_kernel_matches_autograd_of_plain(cuda, shape, pad, taps,
                                                  dtype):
    """The backward launches csrc/fir.cu once on the output's gradient
    (counted as fir_vjp, not fir), equal to autograd of the plain
    version: f32 the same products in another order, bf16 one rounding
    of an fp32 sum on each side."""
    k = (fir.make_blur_kernel([1, 3, 3, 1]) if taps is None
         else torch.tensor(taps))
    x = _randn(cuda, *shape, dtype=dtype)
    xk = x.clone().requires_grad_()
    out = fir.upfirdn2d(xk, k, pad=pad)
    g = _randn(cuda, *out.shape, dtype=dtype)
    before = dict(common.LAUNCHES)
    (got,) = torch.autograd.grad(out, xk, g)
    assert common.LAUNCHES["fir_vjp"] == before["fir_vjp"] + 1
    assert common.LAUNCHES["fir"] == before["fir"]
    xp = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(fir.upfirdn2d_plain(xp, k, 1, 1, pad), xp,
                                  g)
    assert got.shape == x.shape and got.dtype == dtype
    _close(got, want, dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2.0 ** -7, rtol=2.0 ** -7))


def test_fir_double_backward_through_the_kernel_raises(cuda):
    """The kernel's backward is first-order only (R1 differentiates the
    blur twice on the plain versions): a second derivative raises instead
    of coming out wrong."""
    x = _randn(cuda, 2, 16, 16, 128).requires_grad_()
    out = fir.upfirdn2d(x, fir.make_blur_kernel([1, 3, 3, 1]), pad=(2, 2))
    g = _randn(cuda, *out.shape).requires_grad_()
    (dx,) = torch.autograd.grad(out, x, g, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


def test_fir_plan_mirrors_the_c_entry(cuda):
    """The split of the output into blocks, given the occupancy query's
    blocks an SM (the C entry's last value)."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, c, ho, wo, kh, kw in ((8, 128, 257, 257, 4, 4),
                                 (8, 512, 7, 7, 4, 4), (1, 4, 300, 600, 8, 8),
                                 (2, 64, 19, 23, 2, 3), (1, 40, 1, 1, 1, 1)):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if c % (4 if code == 0 else 8):
                continue
            got = cuda_lib.plan("etk_fir_plan", b, c, ho, wo, kh, kw, code,
                                size=10)
            assert got[-1] >= 1
            want = fir.fir_plan(b, c, ho, wo, kw, dtype, sms, got[-1])
            assert got == tuple(want.values()), (b, c, ho, wo, kw, dtype)


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
    # B5 at a head dim between the tiles (48) now computes; 192 is refused
    qkv = _randn(cuda, 1, 16, 3 * 2 * 48, dtype=torch.bfloat16)
    q3, k3, v3 = att.split_qkv_scaled(qkv, 48 ** -0.5)
    do = _randn(cuda, 1, 16, 2 * 48, dtype=torch.bfloat16)
    for g, w in zip(att.attention_bwd_kernel(q3, k3, v3, do, 2, 48),
                    att.attention_bwd_plain(q3, k3, v3, do, 2, 48)):
        _close(g, w, dict(atol=2.0 ** -6 * float(w.float().abs().max()),
                          rtol=2.0 ** -6))
    q = _randn(cuda, 1, 16, 2 * 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.attention_bwd_kernel(q, q, q, q, 2, 192)


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
        0, make_ae_optimizer(model.module.parameters(), 1e-4),
        make_ae_optimizer(model.loss.discriminator.parameters(), 1e-4))
    step = make_vitvq_train_step(model, model.loss)
    x = torch.rand(4, 32, 32, 3, generator=cuda, device="cuda")
    common.reset_launches()
    log = step(state, x, do_r1=True)
    torch.cuda.synchronize()
    # two AE forwards of 2 + 2 layers, one AE backward, three D forwards
    # at 32 px (6 blurs, 9 bias + leaky ReLUs each) and their backwards
    # (the blurs' VJPs on the blur's kernel), one plain D forward
    assert common.LAUNCHES == {"ln_gemm": 16, "attention": 8,
                               "layernorm": 4, "vq": 2, "attention_bwd": 4,
                               "fir": 18, "fir_vjp": 18, "fused_act": 27,
                               "attention_bnhd": 0, "decode_attention": 0,
                               "cache_row_update": 0, "ln_shift_gemm": 0,
                               "int8_gemm": 0, "int8_ln_gemm": 0,
                               "int8_mlp": 0, "attn_proj": 0, "ffn": 0,
                               "attention_bhnd": 0,
                               "attention_fused_bnhd": 0,
                               "attention_gridchunk": 0}
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
    """bf16 at D = 96 (the 128 tile) and fp32 now compute: held to the
    plain version. Still refused: D = 192 and fp16."""
    q = _randn(cuda, 1, 16, 2, 96, dtype=torch.bfloat16)
    _close(att.multihead_attention_bnhd(q, q, q),
           att.attention_bnhd_plain(q, q, q, 96 ** -0.5), ATTN_TOL)
    q = _randn(cuda, 1, 16, 2, 64)
    _close(att.multihead_attention_bnhd(q, q, q),
           att.attention_bnhd_plain(q, q, q, 0.125), F32_TOL)
    q = _randn(cuda, 1, 16, 2, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        att.multihead_attention_bnhd(q, q, q)
    q = _randn(cuda, 1, 16, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        att.multihead_attention_bnhd(q, q, q)


# -- the Hopper attention forward (attn_fwd_kernel, csrc/attention_bnhd.cu) --

def _device_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n,mode,cl", [(1, "none", 0), (63, "prefix_causal", 2),
                                       (64, "none", 0),
                                       (65, "prefix_causal", 70),
                                       (1025, "prefix_causal", 5)])
def test_b2_and_the_strided_entry_are_bit_equal(cuda, d, n, mode, cl):
    """B2 on the qkv buffer and B8 on its three lane slices run one kernel
    through the same tensor maps: the outputs are equal bit for bit."""
    b, h = 2, 3
    qkv = _randn(cuda, b, n, 3 * h * d, dtype=torch.bfloat16)
    got = att.attention_packed_qkv_kernel(qkv, h, d, d ** -0.5, mode, cl)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    strided = att.attention_bnhd_kernel(q, k, v, d ** -0.5, mode, cl)
    torch.cuda.synchronize()
    assert torch.equal(got, strided.view(b, n, h * d))
    _close(got, att.attention_packed_qkv_plain(qkv, h, d, d ** -0.5, mode,
                                               cl), ATTN_TOL)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 3)])
@pytest.mark.parametrize("n,m", [(1, 1), (63, 63), (64, 64), (65, 65),
                                 (1025, 1025), (1, 130), (65, 1),
                                 (130, 257)])
def test_attention_fwd_lengths_masks_and_head_dims(cuda, d, mode, cl, n, m):
    """Lengths below, at and past a 64-row box and a 128-key tile, M != N,
    both masks, every head dim of the Hopper forward: B17 ((B, H, N, D),
    the scale on the scores) and, at M = N, B8 ((B, N, H, D), q scaled in
    bf16), under phase 3's limits."""
    b, h = 2, 2
    q = _randn(cuda, b, h, n, d, dtype=torch.bfloat16)
    k, v = (_randn(cuda, b, h, m, d, dtype=torch.bfloat16) for _ in "kv")
    scale = d ** -0.5
    got = att.multihead_attention(q, k, v, mask_mode=mode, cond_len=cl)
    assert torch.isfinite(got).all()
    _close(got, att.attention_plain(q, k, v, scale, mode, cl), ATTN_TOL)
    if n == m:
        qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = att.multihead_attention_bnhd(qb, kb, vb, mask_mode=mode,
                                           cond_len=cl)
        _close(got, att.attention_bnhd_plain(qb, kb, vb, scale, mode, cl),
               ATTN_TOL)


def test_attention_forwards_route_by_head_dim(cuda):
    """B2, and B8 at D <= 128, launch only attn_fwd_kernel; B8 at the
    prior's D = 384 only attn_wide_kernel, which matches its plain
    version."""
    qkv = _randn(cuda, 2, 100, 3 * 2 * 64, dtype=torch.bfloat16)
    names = _device_kernels(
        lambda: att.attention_packed_qkv_kernel(qkv, 2, 64, 0.125))
    assert len(names) == 1 and "attn_fwd_kernel" in next(iter(names))
    q, k, v = (_randn(cuda, 2, 100, 4, 128, dtype=torch.bfloat16)
               for _ in range(3))
    names = _device_kernels(lambda: att.attention_bnhd_kernel(q, k, v, 0.1))
    assert len(names) == 1 and "attn_fwd_kernel" in next(iter(names))
    q, k, v = (_randn(cuda, 2, 130, 4, 384, dtype=torch.bfloat16)
               for _ in range(3))
    fn = lambda: att.attention_bnhd_kernel(  # noqa: E731
        q, k, v, 384 ** -0.5, "prefix_causal", 1)
    names = _device_kernels(fn)
    assert len(names) == 1 and "attn_wide_kernel" in next(iter(names))
    _close(fn(), att.attention_bnhd_plain(q, k, v, 384 ** -0.5,
                                          "prefix_causal", 1), ATTN_TOL)


def test_attention_packed_qkv_kernel_refusals(cuda):
    """What the B2 wrapper refuses, it refuses before any launch: D = 192
    and 384 (the prior's heads are no ViT's), fp16. D = 48 and 96 (on the
    64 and 128 tiles) and fp32 now compute, held to the plain version."""
    qkv = _randn(cuda, 1, 16, 3 * 2 * 64, dtype=torch.bfloat16)
    for d in (48, 96):
        x = _randn(cuda, 1, 16, 3 * 2 * d, dtype=torch.bfloat16)
        _close(att.attention_packed_qkv_kernel(x, 2, d, 0.1),
               att.attention_packed_qkv_plain(x, 2, d, 0.1), ATTN_TOL)
    for bad_d in (192, 384):
        with pytest.raises(ValueError, match="head_dim"):
            att.attention_packed_qkv_kernel(
                _randn(cuda, 1, 16, 3 * 2 * bad_d, dtype=torch.bfloat16), 2,
                bad_d, 0.1)
    _close(att.attention_packed_qkv_kernel(qkv.float(), 2, 64, 0.1),
           att.attention_packed_qkv_plain(qkv.float(), 2, 64, 0.1), F32_TOL)
    with pytest.raises(TypeError):
        att.attention_packed_qkv_kernel(qkv.half(), 2, 64, 0.1)
    with pytest.raises(ValueError, match="last dim"):
        att.attention_packed_qkv_kernel(qkv[..., :-64], 2, 64, 0.1)
    with pytest.raises(ValueError, match="mask_mode"):
        att.attention_packed_qkv_kernel(qkv, 2, 64, 0.1, "causal")


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


_DECODE_PAIRS = [(torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16),
                 (torch.float32, torch.int8), (torch.bfloat16, torch.int8)]


@pytest.mark.parametrize("q_dtype,cache_dtype", _DECODE_PAIRS)
@pytest.mark.parametrize("cur", [0, 1, 33, 512, 1024, "ragged", "outside"])
def test_decode_attention_every_pair_and_length(cuda, q_dtype, cache_dtype,
                                                cur):
    """The one-launch split-K kernel on all five (q, cache) pairs at the
    prior's head dim, from cur_len 0 (only the new token) to 1024, a
    ragged vector and rows outside [0, ctx) (clamped): against the plain
    version under the limits of the two tests above, each call
    synchronised before it is read."""
    layers, b, ctx, h, d = 3, 4, 1032, 16, 384
    if cur == "ragged":
        cur = torch.tensor([0, 33, 512, 1024], dtype=torch.int32,
                           device="cuda")
    elif cur == "outside":
        cur = torch.tensor([-3, 1032, 1100, 7], dtype=torch.int32,
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
    got = att.decode_attention_stacked(q3, k, v, kn, vn, cur, 2, head_dim=d,
                                       k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert common.LAUNCHES["decode_attention"] == before + 1
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    with common.force_plain_ops():
        want = att.decode_attention_stacked(q3, k, v, kn, vn, cur, 2,
                                            head_dim=d, k_scale=ks,
                                            v_scale=vs)
    if torch.bfloat16 in (q_dtype, cache_dtype):
        _row_close(got, want, 2.0 ** -7, 2.0 ** -7)
    else:
        _row_close(got, want, 1e-5, 1e-5)
    if not isinstance(cur, int) or cur == 0:
        # cur_len 0 and the clamped rows at 0: the output is v_new
        rows = (torch.tensor([True] * b, device="cuda") if isinstance(
            cur, int) else cur <= 0)
        _close(got[rows], vn[rows].to(q_dtype), dict(atol=0.0, rtol=0.0))


def test_decode_attention_is_one_launch(cuda):
    """One decode_attention_kernel call launches exactly one device kernel
    (the split-K kernel; the splits merge inside their cluster), for a
    scalar and a vector cur_len and an int8 cache; its plan is the one
    ops.attention.decode_plan mirrors."""
    from enhancing_tpu_torch.ops import cuda_lib
    layers, b, ctx, h, d = 2, 8, 1032, 16, 384
    k, v = _stack(cuda, layers, b, ctx, h * d, 700, torch.bfloat16)
    q3, kn, vn = (_randn(cuda, b, h * d, dtype=torch.bfloat16)
                  for _ in range(3))
    vec = torch.full((b,), 700, dtype=torch.int32, device="cuda")
    for cur in (700, vec):
        names = _device_kernels(lambda: att.decode_attention_kernel(
            q3, k, v, kn, vn, cur, 1, d))
        assert len(names) == 1 and "decode_kernel" in next(iter(names))
    k8, ks, v8, vs = _int8_stack(cuda, layers, b, ctx, h * d, 700)
    q32 = q3.float()
    names = _device_kernels(lambda: att.decode_attention_kernel(
        q32, k8, v8, q32, q32, 700, 1, d, ks, vs))
    assert len(names) == 1 and "decode_kernel" in next(iter(names))
    for d_ in (32, 64, 128, 384, 512):
        for itemsize in (1, 2, 4):
            if (d_ * itemsize) % 16 == 0:
                want = att.decode_plan(d_, itemsize)
                assert cuda_lib.plan("etk_decode_plan", d_, itemsize) == (
                    want["cluster"], want["warps"], want["keys_per_stage"],
                    want["stages"], want["smem"])


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


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 1536),
                                     (torch.int8, 1536),
                                     (torch.float32, 6144),
                                     (torch.bfloat16, 8),
                                     (torch.int8, 8208)])
@pytest.mark.parametrize("cur", [0, 513, 1031, "ragged", "outside"])
def test_cache_row_update_every_row_size(cuda, dtype, c, cur):
    """The RQ prior's (24, 8, 1032, 1536) stacks, rows of two rounds of 8
    vectors a thread (fp32 6144: 1536 vectors), of a ragged round (int8
    8208: 513) and of one 16-byte vector: bit-exact, one launch, in place;
    rows outside [0, ctx) unwritten."""
    layers, b, ctx = 24, 8, 1032
    if cur == "ragged":
        cur = torch.tensor([0, 1, 5, 513, 700, 1000, 1030, 1031],
                           dtype=torch.int32, device="cuda")
    elif cur == "outside":
        cur = torch.tensor([-1, 1, 1032, 513, 5000, 1000, -7, 1031],
                           dtype=torch.int32, device="cuda")
    if dtype == torch.int8:
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
    assert got.data_ptr() == stack.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", [(8192, 4, 1), (2048, 8, 1),
                                     (4096, 4, 0)])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 1536),
                                     (torch.bfloat16, 6152),
                                     (torch.int8, 8208)])
@pytest.mark.parametrize("cur", [513, "outside"])
def test_cache_row_update_bulk_design_is_exact(cuda, variant, dtype, c, cur):
    """The 1-D bulk-copy design kept beside B10 for its A/B
    (``csrc/cache_row_update_bulk.cu``; no wrapper launches it) at (chunk
    bytes, stages, blocks an SM): rows of one piece and of a ragged last
    piece, bit-exact, rows outside [0, ctx) unwritten."""
    from enhancing_tpu_torch.ops import cuda_lib
    layers, b, ctx = 24, 8, 1032
    if cur == "outside":
        cur = torch.tensor([-1, 1, 1032, 513, 5000, 1000, -7, 1031],
                           dtype=torch.int32, device="cuda")
    if dtype == torch.int8:
        stack, news = (torch.randint(-127, 128, shape, generator=cuda,
                                     device="cuda", dtype=dtype)
                       for shape in ((layers, b, ctx, c), (layers, b, 1, c)))
    else:
        stack = _randn(cuda, layers, b, ctx, c, dtype=dtype)
        news = _randn(cuda, layers, b, 1, c, dtype=dtype)
    want = cache.cache_row_update_plain(stack.clone(), news, cur)
    scalar = isinstance(cur, int)
    cuda_lib.call("etk_cache_row_update_bulk", stack.data_ptr(),
                  news.data_ptr(), None if scalar else cur.data_ptr(),
                  cur if scalar else 0, layers, b, ctx,
                  c * stack.element_size(), *variant, cuda_lib.stream())
    torch.cuda.synchronize()
    assert torch.equal(stack, want)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,h", [(1, 512, 1040), (8, 512, 1040),
                                   (9, 6144, 24576), (17, 256, 1040)])
def test_int8_mlp_wgmma_rows_and_ragged_tiles(cuda, dtype, m, d, h):
    """csrc/int8_mlp.cu at m = 1, 8, 9 and 17 (one, two and three tiles of
    8 rows), h not a multiple of the 64-channel tile (1040), both x dtypes,
    bf16 biases; two calls bit-equal."""
    x = _randn(cuda, m, d, dtype=dtype)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    w0_q, s0 = _quantized(cuda, h, d)
    w1_q, s1 = _quantized(cuda, d, h)
    b0 = 0.1 * _randn(cuda, h, dtype=torch.bfloat16)
    b1 = 0.1 * _randn(cuda, d, dtype=torch.bfloat16)
    res = _randn(cuda, m, d)
    args = (x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, res, "gelu")
    got = int8.int8_mlp_kernel(*args)
    again = int8.int8_mlp_kernel(*args)
    want = int8.int8_mlp_plain(*args)
    tol = _int8_limits(want)
    if dtype == torch.bfloat16:  # as test_int8_mlp_kernel_matches_plain
        tol = dict(atol=2.0 ** -7 * float(want.float().abs().max()),
                   rtol=2.0 ** -7)
    _close(got, want, tol)
    assert torch.equal(got, again)


def test_int8_mlp_plan_mirrors_the_c_entry(cuda):
    """ops.int8.int8_mlp_plan gives the numbers csrc/int8_mlp.cu picks on
    this card, at the prior's widths and the tests' shapes, and both refuse
    the same shapes."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("grid", "groups_b", "groups_c", "splits", "split_chunks",
            "stages", "smem", "ws_bytes", "sync_words")
    for m, d, h in ((8, 6144, 24576), (3, 256, 1024), (19, 512, 2048),
                    (1, 512, 1040), (9, 16, 16)):
        for pieces in (1, 3):
            want = int8.int8_mlp_plan(m, d, h, sms, pieces)
            assert cuda_lib.plan("etk_int8_mlp_plan", m, d, h, pieces,
                                 size=9) == tuple(want[k] for k in keys)
    for m, d, h, pieces in ((0, 256, 1024, 3), (8, 200, 1024, 3),
                            (8, 256, 1000, 1), (8, 256, 1024, 2)):
        with pytest.raises(ValueError):
            int8.int8_mlp_plan(m, d, h, sms, pieces)
        with pytest.raises(RuntimeError):
            cuda_lib.plan("etk_int8_mlp_plan", m, d, h, pieces, size=9)


def _gemm_sync_is_zero():
    """The GEMMs' persistent split counts, every word of them, are back at
    zero after every launch."""
    torch.cuda.synchronize()
    bufs = [buf for key, buf in int8._SCRATCH.items()
            if key[0] == "gemm_sync"]
    return bool(bufs) and all(int(buf.sum()) == 0 for buf in bufs)


# (bias dtype or None, fp32 residual, activation): every option of B12
INT8_GEMM_OPTIONS = ((torch.float32, True, None),
                     (torch.bfloat16, False, "gelu"),
                     (None, True, "sqrelu"),
                     (torch.float32, False, "tanh"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 13, 40])
def test_int8_gemm_wgmma_ragged_rows_and_options(cuda, dtype, m):
    """csrc/int8_gemm.cu on csrc/int8_gemm.cuh at m = 1, 5, 13, 40 (one to
    five tiles of 8 rows), d = 6144 (K split as the plan splits it) and
    n = 1000 (not a multiple of 192: the last group holds one 40-channel
    tile), with every bias dtype, the residual on and off and every
    activation; two calls bit-equal and the split counts left at zero."""
    d, n = 6144, 1000
    x = _randn(cuda, m, d, dtype=dtype)
    w_q, scale = _quantized(cuda, n, d)
    assert int8.int8_gemm_plan(m, d, n, pieces=3 if dtype == torch.float32
                               else 1)["splits"] > 1
    for bias_dtype, residual, act in INT8_GEMM_OPTIONS:
        b = None if bias_dtype is None else 0.1 * _randn(cuda, n,
                                                         dtype=bias_dtype)
        res = _randn(cuda, m, n) if residual else None
        before = common.LAUNCHES["int8_gemm"]
        got = int8.int8_gemm(x, w_q, scale, b, activation=act, residual=res)
        again = int8.int8_gemm(x, w_q, scale, b, activation=act,
                               residual=res)
        assert common.LAUNCHES["int8_gemm"] == before + 2
        want = int8.int8_gemm_plain(x, w_q, scale, b, res, act)
        _close(got, want, _int8_limits(want))
        assert torch.equal(got, again)
    assert _gemm_sync_is_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 5, 13, 40])
def test_int8_ln_gemm_wgmma_ragged_rows_and_options(cuda, dtype, m):
    """csrc/int8_ln_gemm.cu at m = 1, 5, 13, 40, d = 6144, n = 1000: the
    shift on (prev fp32 or bf16) and off, biases fp32, bf16 and none, every
    activation; LN(x) compared too; two calls bit-equal."""
    d, n = 6144, 1000
    x = _randn(cuda, m, d, dtype=dtype, scale=2.0)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    w_q, scale = _quantized(cuda, n, d)
    tm = torch.linspace(0, 1, d, device="cuda")
    for prev_dtype, bias_dtype, act in ((torch.bfloat16, torch.bfloat16, None),
                                        (torch.float32, torch.float32,
                                         "sqrelu"),
                                        (None, None, "gelu"),
                                        (None, torch.float32, "tanh")):
        shift = prev_dtype is not None
        prev = _randn(cuda, m, d, dtype=prev_dtype) if shift else None
        b = None if bias_dtype is None else 0.1 * _randn(cuda, n,
                                                         dtype=bias_dtype)
        args = (x, gamma, beta, tm if shift else None, prev, w_q, scale, b)
        before = common.LAUNCHES["int8_ln_gemm"]
        got, xn = int8.int8_ln_gemm(*args, activation=act)
        again, xn_again = int8.int8_ln_gemm(*args, activation=act)
        assert common.LAUNCHES["int8_ln_gemm"] == before + 2
        want, want_xn = int8.int8_ln_gemm_plain(*args, activation=act)
        _close(got, want, _int8_limits(want))
        _close(xn, want_xn, _int8_limits(want_xn))
        assert torch.equal(got, again) and torch.equal(xn, xn_again)
    assert _gemm_sync_is_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemms_with_more_streams_than_blocks(cuda, dtype):
    """m = 1100: 138 row tiles, more (row tile, split) streams than SMs, so
    a block's units cross streams and it rebuilds its pieces (and, for
    B13, the row statistics) between them; both kernels against their
    plain versions, bit-equal twice."""
    m, d, n = 1100, 256, 200
    plan = int8.int8_gemm_plan(m, d, n, torch.cuda.get_device_properties(
        0).multi_processor_count, 3 if dtype == torch.float32 else 1)
    assert plan["row_tiles"] * plan["splits"] > plan["grid"]
    x = _randn(cuda, m, d, dtype=dtype, scale=2.0)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    tm = torch.linspace(0, 1, d, device="cuda")
    prev = _randn(cuda, m, d, dtype=dtype)
    w_q, scale = _quantized(cuda, n, d)
    b = 0.1 * _randn(cuda, n)
    res = _randn(cuda, m, n)
    got = int8.int8_gemm(x, w_q, scale, b, activation="gelu", residual=res)
    again = int8.int8_gemm(x, w_q, scale, b, activation="gelu", residual=res)
    want = int8.int8_gemm_plain(x, w_q, scale, b, res, "gelu")
    _close(got, want, _int8_limits(want))
    assert torch.equal(got, again)
    args = (x, gamma, beta, tm, prev, w_q, scale, b)
    got, xn = int8.int8_ln_gemm(*args, activation="sqrelu")
    again, _ = int8.int8_ln_gemm(*args, activation="sqrelu")
    want, want_xn = int8.int8_ln_gemm_plain(*args, activation="sqrelu")
    _close(got, want, _int8_limits(want))
    _close(xn, want_xn, _int8_limits(want_xn))
    assert torch.equal(got, again)
    assert _gemm_sync_is_zero()


def test_int8_decode_gemms_at_batch_32_in_decode_order(cuda):
    """The fp32 decode GEMMs of the prior's widths at batch 32, in a decode
    step's order: B13 qkv (4 row tiles x 288 tiles = 1152 split counts),
    B12 proj, qkv, proj, the B13 head, qkv. The split counts and the
    partials live in buffers of their own, so the partials that proj and
    head write cannot stand in qkv's counts; each call against its plain
    version, the repeats bit-equal, every count back at zero."""
    m, c = 32, 6144
    x = _randn(cuda, m, c)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, c), 0.1 * _randn(cuda, c)
    tm = torch.linspace(0, 1, c, device="cuda")
    prev = _randn(cuda, m, c)
    qkv, proj, head = (_quantized(cuda, n, c) for n in (3 * c, c, 8192))
    b = 0.1 * _randn(cuda, 3 * c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert int8.int8_gemm_plan(m, c, 3 * c, sms)["sync_words"] > 1024
    calls = (lambda: int8.int8_ln_gemm(x, gamma, beta, tm, prev, *qkv, b),
             lambda: (int8.int8_gemm(x, *proj, residual=x),),
             lambda: int8.int8_ln_gemm(x, gamma, beta, None, None, *head))
    wants = (int8.int8_ln_gemm_plain(x, gamma, beta, tm, prev, *qkv, b),
             (int8.int8_gemm_plain(x, *proj, residual=x),),
             int8.int8_ln_gemm_plain(x, gamma, beta, None, None, *head))
    firsts = {}
    for i in (0, 1, 0, 1, 2, 0):
        got = calls[i]()
        for g, w in zip(got, wants[i]):
            _close(g, w, _int8_limits(w))
        if i in firsts:
            assert all(torch.equal(g, f) for g, f in zip(got, firsts[i]))
        firsts[i] = got
    assert _gemm_sync_is_zero()


def test_int8_gemm_plan_mirrors_the_c_entry(cuda):
    """ops.int8.int8_gemm_plan gives the numbers csrc/int8_gemm.cuh picks
    on this card, at the prior's four shapes and the tests' shapes, and
    both refuse the same shapes."""
    from enhancing_tpu_torch.ops import cuda_lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("grid", "row_tiles", "groups", "splits", "split_chunks",
            "stages", "smem", "part_bytes", "sync_words")
    for m, d, n in ((8, 6144, 6144), (8, 6144, 18432), (8, 6144, 8192),
                    (1, 6144, 1000), (13, 6144, 1000), (40, 6144, 1000),
                    (3, 256, 200), (20, 1040, 96), (5, 512, 136),
                    (1100, 256, 200)):
        for pieces in (1, 3):
            want = int8.int8_gemm_plan(m, d, n, sms, pieces)
            assert cuda_lib.plan("etk_int8_gemm_plan", m, d, n, pieces,
                                 size=9) == tuple(want[k] for k in keys)
    for m, d, n, pieces in ((0, 256, 1024, 3), (8, 200, 1024, 3),
                            (8, 256, 0, 1), (8, 256, 1024, 2)):
        with pytest.raises(ValueError):
            int8.int8_gemm_plan(m, d, n, sms, pieces)
        with pytest.raises(RuntimeError):
            cuda_lib.plan("etk_int8_gemm_plan", m, d, n, pieces, size=9)


def _ln_shift_sync_is_zero():
    """B11's persistent split counts are back at zero after every launch."""
    torch.cuda.synchronize()
    bufs = [buf for key, buf in int8._SCRATCH.items()
            if key[0] == "ln_shift_sync"]
    return all(int(buf.sum()) == 0 for buf in bufs)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,d,n,shift", [(8, 6144, 18432, True),
                                         (4, 384, 264, False),
                                         (13, 1040, 1000, True)])
def test_ln_shift_gemm_kernel_matches_plain(cuda, x_dtype, w_dtype, m, d, n,
                                            shift):
    """csrc/ln_shift_gemm.cu (int8_gemm.cuh's body on bf16 or fp32
    weights): every dtype pair, the shift on and off, d not a multiple of
    the 128-wide stage and n not of 192 channels; LN(x) compared too, two
    calls bit-equal, the split counts left at zero."""
    x = _randn(cuda, m, d, dtype=x_dtype, scale=2.0)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, d), 0.1 * _randn(cuda, d)
    tm = torch.linspace(0, 1, d, device="cuda") if shift else None
    prev = _randn(cuda, m, d, dtype=torch.bfloat16) if shift else None
    w = _randn(cuda, n, d, dtype=w_dtype, scale=d ** -0.5)
    b = 0.1 * _randn(cuda, n)
    before = common.LAUNCHES["ln_shift_gemm"]
    got, xn = lg.fused_ln_shift_gemm(x, gamma, beta, tm, prev, w, b)
    again, xn_again = lg.fused_ln_shift_gemm(x, gamma, beta, tm, prev, w, b)
    assert common.LAUNCHES["ln_shift_gemm"] == before + 2
    want, want_xn = lg.ln_shift_gemm_plain(x, gamma, beta, tm, prev, w, b)
    _close(got, want, _int8_limits(want))
    _close(xn, want_xn, _int8_limits(want_xn))
    assert torch.equal(got, again) and torch.equal(xn, xn_again)
    assert _ln_shift_sync_is_zero()


@pytest.mark.parametrize("m", [1, 8, 13, 32])
def test_ln_shift_gemm_decode_sites_in_decode_order(cuda, m):
    """The LNFUSE decode step's three fp32 calls at the prior's widths and
    batch 1-32, in a decode step's order, through one shared scratch: B11
    at the qkv (the shift, bf16 W), B1 at the mlp (sqrelu) and the head,
    which at these rows run B11's kernel without the shift on the bf16
    weights as stored; qkv, mlp, qkv, head, qkv again. Each call against
    its plain version, the repeats bit-equal, every split count back at
    zero (partials of one call left in another's counts would show
    here)."""
    c = 6144
    x = _randn(cuda, m, c)
    gamma, beta = 1.0 + 0.1 * _randn(cuda, c), 0.1 * _randn(cuda, c)
    tm = torch.linspace(0, 1, c, device="cuda")
    prev = _randn(cuda, m, c, dtype=torch.bfloat16)
    qkv, p0, head = (_randn(cuda, n, c, dtype=torch.bfloat16, scale=0.02)
                     for n in (3 * c, 4 * c, 8192))
    bq, b0 = 0.02 * _randn(cuda, 3 * c), 0.02 * _randn(cuda, 4 * c)
    assert lg.ln_gemm_route(m, x.dtype, p0.dtype) == "decode"
    calls = (lambda: lg.fused_ln_shift_gemm(x, gamma, beta, tm, prev, qkv,
                                            bq),
             lambda: (lg.fused_ln_gemm(x, gamma, beta, p0, b0,
                                       activation="sqrelu"),),
             lambda: (lg.fused_ln_gemm(x, gamma, beta, head),))
    wants = (lg.ln_shift_gemm_plain(x, gamma, beta, tm, prev, qkv, bq),
             (lg.ln_gemm_plain(x, gamma, beta, p0, b0, "sqrelu"),),
             (lg.ln_gemm_plain(x, gamma, beta, head),))
    firsts = {}
    before = dict(common.LAUNCHES)
    for i in (0, 1, 0, 2, 0):
        got = calls[i]()
        for g, w in zip(got, wants[i]):
            _close(g, w, _int8_limits(w))
        if i in firsts:
            assert all(torch.equal(g, f) for g, f in zip(got, firsts[i]))
        firsts[i] = got
    assert common.LAUNCHES["ln_shift_gemm"] == before["ln_shift_gemm"] + 3
    assert common.LAUNCHES["ln_gemm"] == before["ln_gemm"] + 2
    assert _ln_shift_sync_is_zero()


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


# -- the fused serving path's kernels and the other attention forwards ------

def _proj_operands(gen, b, n, h, ho):
    """The lane slices of a bf16 qkv buffer as (B, N, H, 64) views, a bf16
    (HO, H*64) weight, an fp32 bias and a bf16 residual."""
    qkv = _randn(gen, b, n, 3 * h * 64, dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, 64)) for t in qkv.chunk(3, -1))
    wp = _randn(gen, ho, h * 64, dtype=torch.bfloat16,
                scale=(2.0 / (h * 64 + ho)) ** 0.5)
    bp = _randn(gen, ho, scale=0.02)
    res = _randn(gen, b, n, ho, dtype=torch.bfloat16)
    return q, k, v, wp, bp, res


@pytest.mark.parametrize("b,n,h,ho,mode,cl", [
    (2, 1024, 12, 768, "none", 0),     # ViT-Base
    (1, 1025, 12, 768, "none", 0),     # a ragged last row block
    (2, 130, 4, 256, "prefix_causal", 5),
    (1, 200, 2, 64, "prefix_causal", 100),  # cond_len past a block
    (1, 256, 16, 1280, "none", 0),     # imagenet_vitvq_large's decoder
    (1, 64, 3, 128, "none", 0),        # an odd head count
])
def test_attn_proj_kernel_matches_plain(cuda, b, n, h, ho, mode, cl):
    """B15 on the qkv buffer's lane slices. bf16 outputs of O(1), each side
    rounding its fp32 sum once; P rounds against the running row max in
    the kernel: one bf16 step of each element + 2^-8 of its row's
    largest."""
    q, k, v, wp, bp, res = _proj_operands(cuda, b, n, h, ho)
    before = common.LAUNCHES["attn_proj"]
    with torch.no_grad():
        got = att.attention_proj_packed(q, k, v, wp, bp, res, mask_mode=mode,
                                        cond_len=cl)
    assert common.LAUNCHES["attn_proj"] == before + 1
    want = att.attention_proj_plain(q, k, v, wp, bp, res, 0.125, mode, cl)
    _row_close(got.view(-1, ho), want.view(-1, ho), 2.0 ** -8, 2.0 ** -7)


def test_attn_proj_under_autograd_runs_the_unfused_kernels(cuda):
    """Under grad the entry point runs B8 and, backward, B5; its gradients
    against autograd of the plain version (as in the B5 tests)."""
    b, n, h, ho = 2, 130, 4, 256
    q, k, v, wp, bp, res = _proj_operands(cuda, b, n, h, ho)
    g = _randn(cuda, b, n, ho, dtype=torch.bfloat16)
    grads = []
    for kernels in (True, False):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, wp, bp, res)]
        before = dict(common.LAUNCHES)
        if kernels:
            out = att.attention_proj_packed(*leaves, mask_mode="prefix_causal",
                                            cond_len=3)
        else:
            out = att.attention_proj_plain(*leaves, 0.125, "prefix_causal",
                                           3)
        out.backward(g)
        used = {k_: v_ - before[k_] for k_, v_ in common.LAUNCHES.items()
                if v_ != before[k_]}
        assert used == ({"attention_bnhd": 1, "attention_bwd": 1}
                        if kernels else {})
        grads.append([t.grad for t in leaves])
    for name, got, want in zip("qkvwbr", *grads):
        _grad_close(got, want, name)


@pytest.mark.parametrize("m,d,h,act", [
    (8192, 768, 3072, "tanh"),   # ViT-Base at batch 8
    (1000, 768, 3072, "tanh"),   # a ragged last row block
    (300, 1280, 5120, "gelu"),   # imagenet_vitvq_large's decoder
    (129, 512, 2048, "sqrelu"),  # imagenet_vitvq_small
    (33, 64, 128, "tanh"),       # fake_vitvq_tiny
])
def test_ffn_kernel_matches_plain(cuda, m, d, h, act):
    """B16: bf16 outputs, one rounding on each side of fp32 sums in another
    order (a hidden element may round the other way): one bf16 step of
    each element + 2^-8 of its row's largest."""
    x = _randn(cuda, m, d, dtype=torch.bfloat16)
    w1 = _randn(cuda, h, d, dtype=torch.bfloat16, scale=(2 / (d + h)) ** .5)
    w2 = _randn(cuda, d, h, dtype=torch.bfloat16, scale=(2 / (d + h)) ** .5)
    b1, b2 = _randn(cuda, h, scale=0.02), _randn(cuda, d, scale=0.02)
    before = common.LAUNCHES["ffn"]
    got = ffn.fused_ffn(x, w1, b1, w2, b2, activation=act)
    assert common.LAUNCHES["ffn"] == before + 1
    _row_close(got, ffn.ffn_plain(x, w1, b1, w2, b2, act), 2.0 ** -8,
               2.0 ** -7)


@pytest.mark.parametrize("m,d,h,act", [
    (1000, 64, 192, "tanh"),     # C 1, slabs of 64
    (1000, 128, 320, "gelu"),    # C 1, slabs of 128
    (700, 320, 704, "sqrelu"),   # C 2, slabs of 160, last group short
    (1000, 448, 704, "tanh"),    # C 2, slabs of 256 past d, short group
    (1000, 768, 3008, "tanh"),   # C 4, two buffers, last group of 3
    (300, 1024, 4032, "gelu"),   # C 4, one buffer, last group of 3
    (300, 1280, 5056, "tanh"),   # C 8, last group of 7
    (129, 2048, 1024, "tanh"),   # C 8, slabs of 256, the widest
])
def test_ffn_cluster_plans_match_plain(cuda, m, d, h, act):
    """B16 at every cluster size, slab width and buffer count that
    ops.ffn.ffn_plan picks, with a short last group where h / 64 is no
    multiple of the cluster; limits as test_ffn_kernel_matches_plain."""
    x = _randn(cuda, m, d, dtype=torch.bfloat16)
    w1 = _randn(cuda, h, d, dtype=torch.bfloat16, scale=(2 / (d + h)) ** .5)
    w2 = _randn(cuda, d, h, dtype=torch.bfloat16, scale=(2 / (d + h)) ** .5)
    b1, b2 = _randn(cuda, h, scale=0.02), _randn(cuda, d, scale=0.02)
    got = ffn.fused_ffn(x, w1, b1, w2, b2, activation=act)
    _row_close(got, ffn.ffn_plain(x, w1, b1, w2, b2, act), 2.0 ** -8,
               2.0 ** -7)


def test_ffn_backward_is_the_plain_gradient(cuda):
    m, d, h = 200, 128, 256
    args = [_randn(cuda, m, d, dtype=torch.bfloat16),
            _randn(cuda, h, d, dtype=torch.bfloat16, scale=0.1),
            _randn(cuda, h, scale=0.02),
            _randn(cuda, d, h, dtype=torch.bfloat16, scale=0.1),
            _randn(cuda, d, scale=0.02)]
    g = _randn(cuda, m, d, dtype=torch.bfloat16)
    grads = []
    for fn in (lambda *t: ffn.fused_ffn(*t, activation="tanh"),
               lambda *t: ffn.ffn_plain(*t, "tanh")):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, dict(atol=0.0, rtol=0.0))


@pytest.mark.parametrize("b,h,n,m,mode,cl", [
    (2, 12, 1024, 1024, "none", 0),
    (2, 4, 300, 517, "prefix_causal", 5),
    (1, 4, 517, 300, "none", 0),
    (1, 2, 70, 70, "prefix_causal", 100),
])
def test_multihead_attention_kernel_matches_plain(cuda, b, h, n, m, mode, cl):
    """B17: (B, H, N, D), the scale on the fp32 scores, M != N."""
    q = _randn(cuda, b, h, n, 64, dtype=torch.bfloat16)
    k, v = (_randn(cuda, b, h, m, 64, dtype=torch.bfloat16) for _ in "kv")
    before = common.LAUNCHES["attention_bhnd"]
    got = att.multihead_attention(q, k, v, mask_mode=mode, cond_len=cl)
    assert common.LAUNCHES["attention_bhnd"] == before + 1
    _close(got, att.attention_plain(q, k, v, 0.125, mode, cl), ATTN_TOL)


@pytest.mark.parametrize("b,n,h,mode,cl", [(2, 1024, 12, "none", 0),
                                           (1, 1025, 4, "prefix_causal", 9)])
def test_attention_fused_bnhd_kernel_matches_plain(cuda, b, n, h, mode, cl):
    """B18: (B, N, H, D), the scale on the fp32 scores."""
    q, k, v = (_randn(cuda, b, n, h, 64, dtype=torch.bfloat16)
               for _ in range(3))
    before = common.LAUNCHES["attention_fused_bnhd"]
    got = att._attention_fused_bnhd(q, k, v, 0.125, mode, cl)
    assert common.LAUNCHES["attention_fused_bnhd"] == before + 1
    _close(got, att.attention_fused_bnhd_plain(q, k, v, 0.125, mode, cl),
           ATTN_TOL)


@pytest.mark.parametrize("b,n,hd,d,cl", [(8, 1025, 1024, 64, 1),
                                         (8, 1025, 1024, 64, 100),
                                         (2, 160, 256, 64, 3),
                                         (1, 130, 128, 128, 1)])
def test_attention_gridchunk_kernel_matches_plain(cuda, b, n, hd, d, cl):
    """B19 at the stage-2 training shape (cond_len 1 and 100, past a key
    tile) and at the JAX test's shapes."""
    q3 = _randn(cuda, b, n, hd, dtype=torch.bfloat16, scale=0.125)
    k3, v3 = (_randn(cuda, b, n, hd, dtype=torch.bfloat16) for _ in "kv")
    before = common.LAUNCHES["attention_gridchunk"]
    got = att.attention_packed_gridchunk(q3, k3, v3, "prefix_causal", cl, d)
    assert common.LAUNCHES["attention_gridchunk"] == before + 1
    _close(got, att.attention_packed_plain(q3, k3, v3, "prefix_causal", cl,
                                           d), ATTN_TOL)


def test_bhnd_attention_backward_is_the_plain_gradient(cuda):
    q, k, v = (_randn(cuda, 1, 2, 100, 64, dtype=torch.bfloat16)
               for _ in range(3))
    g = _randn(cuda, 1, 2, 100, 64, dtype=torch.bfloat16)
    grads = []
    for fn in (lambda *t: att.multihead_attention(*t),
               lambda *t: att.attention_plain(*t, 0.125)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        _close(got, want, dict(atol=0.0, rtol=0.0))


def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, wp, bp, res = _proj_operands(cuda, 1, 64, 2, 128)
    # fp32 runs csrc/attn_proj_f32.cu; mixed dtypes are refused
    f32 = [t.float() for t in (q, k, v, wp)] + [bp, res.float()]
    _close(att.attn_proj_kernel(*f32, 0.1),
           att.attention_proj_plain(*f32, 0.1), dict(atol=1e-4, rtol=1e-5))
    with pytest.raises(TypeError):  # fp32 activations, a bf16 weight
        att.attn_proj_kernel(q.float(), k.float(), v.float(), wp, bp,
                             res.float(), 0.1)
    with pytest.raises(ValueError):  # HO not a multiple of 64
        att.attn_proj_kernel(q, k, v, wp[:100], bp[:100], res[..., :100],
                             0.1)
    x = _randn(cuda, 8, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d not a multiple of 64
        ffn.ffn_kernel(x, _randn(cuda, 128, 96, dtype=torch.bfloat16),
                       _randn(cuda, 128), _randn(cuda, 96, 128,
                                                 dtype=torch.bfloat16),
                       _randn(cuda, 96))
    # head dim 48 now runs on the 64 tile; 192 is refused
    q48 = _randn(cuda, 1, 2, 8, 48, dtype=torch.bfloat16)
    _close(att.multihead_attention(q48, q48, q48),
           att.attention_plain(q48, q48, q48, 48 ** -0.5), ATTN_TOL)
    with pytest.raises(ValueError):  # head dim 192
        att.multihead_attention(*(_randn(cuda, 1, 2, 8, 192,
                                         dtype=torch.bfloat16),) * 3)


def test_fused_tiny_round_trip_goes_through_the_fused_kernels(cuda,
                                                              monkeypatch):
    """fake_vitvq_tiny's towers with ffn_impl 'fused' and
    ENHANCING_TPU_ATTN_PROJ=1: per block B1 (LN1 -> qkv), B15, B3 (LN2),
    B16; B3 at each stack's end; B4."""
    from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
    monkeypatch.setenv("ENHANCING_TPU_ATTN_PROJ", "1")
    tower = dict(dim=64, depth=2, heads=2, mlp_dim=128, ffn_impl="fused")
    model = ViTVQ(image_size=32, patch_size=8, encoder=tower, decoder=tower,
                  quantizer=dict(embed_dim=16, n_embed=128),
                  dtype="bfloat16", device="cuda")
    x = torch.rand(3, 32, 32, 3, generator=cuda, device="cuda")
    common.reset_launches()
    rec = model.decode_codes(model.encode_codes(x))
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "ln_gemm": 4, "attn_proj": 4, "layernorm": 6, "ffn": 4, "vq": 1}
    assert rec.shape == (3, 32, 32, 3) and torch.isfinite(rec).all()
