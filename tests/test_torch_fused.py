"""The port's fused serving path and its remaining attention forwards
against the JAX package's, on the CPU.

B15 (attention -> projection -> residual), B16 (the fused FFN), B17
((B, H, N, D) attention), B18 ((B, N, H, D) attention) and B19 (the
grid-chunked prefix-causal forward): inputs made with numpy from a seed go
through the JAX Pallas kernel in interpret mode
(ENHANCING_TPU_PALLAS_INTERPRET=1) and through the port's plain PyTorch
version, which is what CPU tensors dispatch to. Then the slice: the
ViT-VQGAN round trip with ``ffn_impl: fused`` and
ENHANCING_TPU_ATTN_PROJ=1 in both packages, the weights carried by
``load_vitvq_from_jax``. Each tolerance is stated beside its assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage1.vitvqgan import ViTVQ as JaxViTVQ
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.ops import common as jcommon
from enhancing_tpu.ops import ffn as jffn
from enhancing_tpu_torch.compat.from_jax import load_vitvq_from_jax
from enhancing_tpu_torch.models.stage1.layers import resolve_ffn_impl
from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.ops import ffn as tffn
from enhancing_tpu_torch.utils.config import initialize_from_config

# f32 with another summation order on each side: a few ulps of O(1) values
F32_TOL = dict(atol=3e-5, rtol=1e-5)
# gradients: sums over the batch and the sequence, ulps of O(10) values
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- B15 ----------------------------------------------------------------------

# the cases of tests/test_ops.py::test_attention_proj_fused_matches_xla
PROJ_CASES = [((2, 64, 4, 64), "none", 0), ((1, 64, 2, 128), "none", 0),
              ((1, 33, 4, 64), "prefix_causal", 3)]


def _proj_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, n, h, d = shape
    hd, ho = h * d, 128
    q3, k3, v3 = (_normal(rng, (b, n, hd), 0.2) for _ in range(3))
    wp = _normal(rng, (hd, ho), 0.05)
    bp = _normal(rng, (ho,), 0.1)
    res = _normal(rng, (b, n, ho))
    g = _normal(rng, (b, n, ho))
    return q3, k3, v3, wp, bp, res, g


@pytest.mark.parametrize("shape,mode,cl", PROJ_CASES)
def test_attention_proj_matches_jax(interpret, shape, mode, cl):
    b, n, h, d = shape
    q3, k3, v3, wp, bp, res, _ = _proj_inputs(shape, 0)
    want = jatt._attention_proj_packed_call(*map(jnp.asarray, (
        q3, k3, v3, wp, bp, res)), mode, cl, d)
    # q3 is pre-scaled on the JAX side: a unit scale on the port's
    got = tatt.attention_proj_packed(
        *(_t(a).view(b, n, h, d) for a in (q3, k3, v3)), _t(wp.T), _t(bp),
        _t(res), scale=1.0, mask_mode=mode, cond_len=cl)
    assert got.shape == (b, n, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shape,mode,cl", PROJ_CASES)
def test_attention_proj_gradients_match_jax(interpret, shape, mode, cl):
    """d(q, k, v, Wp, bp, residual) of <out, g> against jax.grad through
    ``_attention_proj_fused`` (its unfused custom_vjp forward and packed
    backward)."""
    b, n, h, d = shape
    q3, k3, v3, wp, bp, res, g = _proj_inputs(shape, 1)

    def loss(*args):
        out = jatt._attention_proj_fused(*args, mode, cl, d)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, (
        q3, k3, v3, wp, bp, res)))
    leaves = [_t(a, True) for a in (q3, k3, v3, wp.T, bp, res)]
    out = tatt.attention_proj_packed(
        *(t.view(b, n, h, d) for t in leaves[:3]), *leaves[3:], scale=1.0,
        mask_mode=mode, cond_len=cl)
    (out * _t(g)).sum().backward()
    for name, t, w in zip(("q", "k", "v", "wp", "bp", "residual"), leaves,
                          want):
        got = t.grad.numpy().T if name == "wp" else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


# -- B16 ----------------------------------------------------------------------

FFN_SHAPE = (40, 128, 1024)  # m, d, h: two of the TPU kernel's 512 chunks


def _ffn_inputs(seed):
    rng = np.random.default_rng(seed)
    m, d, h = FFN_SHAPE
    x = _normal(rng, (m, d))
    w1 = _normal(rng, (d, h), d ** -0.5)
    b1 = _normal(rng, (h,), 0.1)
    w2 = _normal(rng, (h, d), h ** -0.5)
    b2 = _normal(rng, (d,), 0.1)
    g = _normal(rng, (m, d))
    return x, w1, b1, w2, b2, g


def _port_ffn(x, w1, b1, w2, b2, activation, dtype=torch.float32, grad=False):
    leaves = [_t(a, grad) for a in (x, w1.T, b1, w2.T, b2)]
    x_, w1_, b1_, w2_, b2_ = leaves
    out = tffn.fused_ffn(x_.to(dtype), w1_, b1_, w2_, b2_,
                         activation=activation)
    return out, leaves


@pytest.mark.parametrize("activation", ["tanh", "sqrelu", "gelu"])
def test_fused_ffn_matches_jax(interpret, activation):
    x, w1, b1, w2, b2, _ = _ffn_inputs(0)
    want = jffn._ffn_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                            activation)
    got, _ = _port_ffn(x, w1, b1, w2, b2, activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("activation", ["tanh", "sqrelu", "gelu"])
def test_fused_ffn_bf16_matches_jax(interpret, activation):
    """bf16 x and weights, fp32 biases, through the TPU kernel's numerics
    on both sides. Each side rounds its output to bf16 once (2^-8
    relative), and a hidden element whose fp32 value lies near a rounding
    boundary may round the other way after fp32 sums in another order:
    two bf16 steps of the output's scale, atol 2^-7 * max |out| + rtol
    2^-7."""
    x, w1, b1, w2, b2, _ = _ffn_inputs(1)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w1, w2)]
    want = np.asarray(jffn._ffn_pallas(bf[0], bf[1], jnp.asarray(b1), bf[2],
                                       jnp.asarray(b2), activation)
                      .astype(jnp.float32))
    got, _ = _port_ffn(np.asarray(bf[0].astype(jnp.float32)),
                       np.asarray(bf[1].astype(jnp.float32)), b1,
                       np.asarray(bf[2].astype(jnp.float32)), b2, activation,
                       dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max(),
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("activation", ["tanh", "sqrelu", "gelu"])
def test_fused_ffn_gradients_match_jax(interpret, activation):
    x, w1, b1, w2, b2, g = _ffn_inputs(2)

    def loss(*args):
        return jnp.sum(jffn._ffn_fused(*args, activation) * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, (
        x, w1, b1, w2, b2)))
    out, leaves = _port_ffn(x, w1, b1, w2, b2, activation, grad=True)
    (out * _t(g)).sum().backward()
    for name, t, w in zip(("x", "w1", "b1", "w2", "b2"), leaves, want):
        got = t.grad.numpy().T if name in ("w1", "w2") else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


# -- B17-B19 ------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(40, 56), (64, 24)])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 5)])
def test_multihead_attention_matches_jax(interpret, n, m, mode, cl):
    """B17: (B, H, N, D) attention with M != N, the scale on the scores;
    also its gradients against jax.grad (the XLA VJP on both sides)."""
    rng = np.random.default_rng(3)
    q = _normal(rng, (2, 3, n, 32))
    k, v = (_normal(rng, (2, 3, m, 32)) for _ in range(2))
    g = _normal(rng, (2, 3, n, 32))
    want = jatt.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                    mask_mode=mode, cond_len=cl,
                                    impl="pallas")
    leaves = [_t(a, True) for a in (q, k, v)]
    got = tatt.multihead_attention(*leaves, mask_mode=mode, cond_len=cl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    grads = jax.grad(lambda *a: jnp.sum(jatt.multihead_attention(
        *a, mask_mode=mode, cond_len=cl, impl="pallas") * jnp.asarray(g)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (got * _t(g)).sum().backward()
    for t, w in zip(leaves, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 7)])
def test_attention_fused_bnhd_matches_jax(interpret, mode, cl):
    """B18 at tests/test_ops.py::test_attention_bnhd_matches_bhnd's shape."""
    rng = np.random.default_rng(4)
    b, n, h, d = 2, 64, 4, 32
    q, k, v = (_normal(rng, (b, n, h, d)) for _ in range(3))
    want = jatt._attention_pallas_bnhd(*map(jnp.asarray, (q, k, v)),
                                       d ** -0.5, mode, cl)
    got = tatt._attention_fused_bnhd(_t(q), _t(k), _t(v), d ** -0.5, mode, cl)
    assert got.shape == (b, n, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# the cases of tests/test_ops.py::test_attention_gridchunk_matches_xla
@pytest.mark.parametrize("b,n,hd,d,cl", [(2, 160, 256, 64, 3),
                                         (1, 130, 128, 128, 1),
                                         (1, 160, 128, 64, 100)])
def test_attention_gridchunk_matches_jax(interpret, b, n, hd, d, cl):
    rng = np.random.default_rng(5)
    q = _normal(rng, (b, n, hd), 0.1)
    k, v = (_normal(rng, (b, n, hd)) for _ in range(2))
    want = jatt._attention_packed_gridchunk_call(
        *map(jnp.asarray, (q, k, v)), "prefix_causal", cl, d, block_q=64,
        k_chunk=64)
    got = tatt.attention_packed_gridchunk(_t(q), _t(k), _t(v),
                                          "prefix_causal", cl, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- what the kernels refuse --------------------------------------------------

def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("call,error", [
    # B15: head dim 32 (the kernel is built for the stage-1 configs' 64)
    (lambda: tatt.attn_proj_kernel(_bf(1, 8, 2, 32), _bf(1, 8, 2, 32),
                                   _bf(1, 8, 2, 32), _bf(64, 64),
                                   torch.zeros(64), _bf(1, 8, 64), 0.1),
     ValueError),
    # B15: fp32 activations
    (lambda: tatt.attn_proj_kernel(*(torch.zeros(1, 8, 2, 64),) * 3,
                                   torch.zeros(64, 128), torch.zeros(64),
                                   torch.zeros(1, 8, 64), 0.1), TypeError),
    # B16: a width that is no multiple of 64
    (lambda: tffn.ffn_kernel(_bf(8, 96), _bf(128, 96), torch.zeros(128),
                             _bf(96, 128), torch.zeros(96)), ValueError),
    # B16: wider than the widest cluster's slabs (8 x 256)
    (lambda: tffn.ffn_kernel(_bf(8, 2112), _bf(128, 2112), torch.zeros(128),
                             _bf(2112, 128), torch.zeros(2112)), ValueError),
    # B16: fp32 x
    (lambda: tffn.ffn_kernel(torch.zeros(8, 64), _bf(128, 64),
                             torch.zeros(128), _bf(64, 128),
                             torch.zeros(64)), TypeError),
    # B17-B19: a head dim no attention kernel takes (not a multiple of 8
    # up to 128, nor 384), and fp16 (bf16 and fp32 run)
    (lambda: tatt.attention_bhnd_kernel(*(_bf(1, 2, 8, 192),) * 3, 0.1),
     ValueError),
    (lambda: tatt.attention_strided_kernel(
        "attention_fused_bnhd",
        *(torch.zeros(1, 8, 2, 64, dtype=torch.float16),) * 3, 0.1),
     TypeError),
    # B19 is prefix-causal only, as the TPU kernel masks
    (lambda: tatt.attention_packed_gridchunk(_bf(1, 8, 64), _bf(1, 8, 64),
                                             _bf(1, 8, 64), "none", 0, 64),
     ValueError),
])
def test_kernels_refuse_what_they_do_not_take(call, error):
    """The argument checks run before any launch, so a CUDA tensor of a
    shape or dtype a kernel does not take raises; shown on CPU tensors."""
    with pytest.raises(error):
        call()


def test_raw_launch_under_autograd_raises():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tatt.attention_strided_kernel("attention_fused_bnhd", q, q, q, 0.1)


# -- the kernels' host-side plans, mirrored in Python ---------------------

# the H100's limits that a plan must respect: shared memory a block may
# use (227 KB) with the kernels' static barriers (< 1 KB) beside it; a
# consumer thread's registers (setmaxnreg 232), of which the kernels' own
# addressing and staging take ~30
SMEM_PER_BLOCK, STATIC_SMEM, CONSUMER_REGS = 232448, 1024, 232
CLUSTER_LIMIT = 8


@pytest.mark.parametrize("d", range(64, 2049, 64))
def test_ffn_plan_fits_the_card(d):
    """Every width the fused FFN takes gets a cluster of 1, 2, 4 or 8 (a
    divisor of the portable cluster limit) whose slabs cover d with the
    fewest padded columns, 128-row blocks of two 64-row wgmma warpgroups,
    accumulators (a slab and a 64-wide hidden chunk, fp32, over 128
    threads of 64 rows) within the register budget, a ring of at least 3
    stages and shared memory within the block's limit."""
    plan = tffn.ffn_plan(d)
    c, ds = plan["cluster"], plan["slab"]
    assert c in tffn.FFN_CLUSTERS and CLUSTER_LIMIT % c == 0
    assert ds in tffn.FFN_SLABS and ds % 8 == 0 and ds <= 256
    assert c * ds >= d
    assert all(cc * dd < d or cc * dd - d >= c * ds - d
               for cc in tffn.FFN_CLUSTERS for dd in tffn.FFN_SLABS)
    assert tffn.FFN_TILE_M == 2 * 64 and plan["chunk"] % 16 == 0
    assert (ds + plan["chunk"]) * 64 // 128 + 30 <= CONSUMER_REGS
    assert plan["buffers"] in (1, 2) and 3 <= plan["stages"] <= 8
    slots = plan["buffers"] * c * tffn.FFN_TILE_M * plan["chunk"] * 2
    stage = max(16384 + plan["chunk"] * 128, ds * 128)
    assert plan["smem"] == slots + plan["stages"] * stage + 1024
    assert plan["smem"] + STATIC_SMEM <= SMEM_PER_BLOCK
    # the flush stages the fp32 (128, DS + 8) accumulators in that memory
    assert 128 * (ds + 8) * 4 <= slots + plan["stages"] * stage


def test_ffn_plan_refuses_wider_widths():
    assert tffn.ffn_plan(tffn.FFN_MAX_D + 64) is None
    assert tffn.ffn_plan(768)["cluster"] == 4  # ViT-Base: 4 slabs of 192
    assert tffn.ffn_plan(1280)["cluster"] == 8  # the large decoder


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", [1, 100, 1000, 1024, 8192, 131072])
@pytest.mark.parametrize("n", [8, 136, 2304, 2312, 3072])
def test_ln_gemm_plan_fits_the_card(sms, m, n):
    """The bf16 LN -> GEMM's tiles: 128 rows (two 64-row wgmma warpgroups)
    by 256 columns, or 128 when 256-wide tiles would leave SMs idle;
    accumulators and two k tiles of A fragments within the register
    budget; a persistent grid of at most one block an SM and a tile."""
    from enhancing_tpu_torch.ops import ln_gemm as tlg
    plan = tlg.ln_gemm_plan(m, n, sms)
    rows = -(-m // 128)
    assert plan["tile_m"] == 2 * 64
    assert plan["tile_n"] == (256 if rows * -(-n // 256) >= sms else 128)
    assert plan["tile_n"] // 2 + 2 * 4 * 4 + 30 <= CONSUMER_REGS
    assert plan["stages"] >= 3
    assert plan["smem"] + STATIC_SMEM <= SMEM_PER_BLOCK
    # the epilogue stages 64 x tile_n bf16 per warpgroup beside the ring
    ring = plan["stages"] * (128 + plan["tile_n"]) * 64 * 2
    assert plan["smem"] == ring + 2 * 64 * plan["tile_n"] * 2 + 1024
    assert 1 <= plan["grid"] == min(rows * -(-n // plan["tile_n"]), sms)


# -- the slice: the tokenizer round trip with both fusions ------------------

def test_resolve_ffn_impl(monkeypatch):
    monkeypatch.delenv("ENHANCING_TPU_FUSED_FFN", raising=False)
    assert resolve_ffn_impl(None) == "dense"
    assert resolve_ffn_impl("fused") == "fused"
    monkeypatch.setenv("ENHANCING_TPU_FUSED_FFN", "1")
    assert resolve_ffn_impl(None) == "fused"
    monkeypatch.setenv("ENHANCING_TPU_FUSED_FFN", "0")
    assert resolve_ffn_impl("fused") == "dense"


def _fused_pair(tower, image_size):
    tower = dict(tower, ffn_impl="fused")
    kw = dict(image_size=image_size, patch_size=8, encoder=tower,
              decoder=tower, quantizer=dict(embed_dim=32, n_embed=512))
    jm = JaxViTVQ(seed=0, **kw)
    tm = ViTVQ(device="cpu", **kw)
    # the parameter names are those of the default branches: no change to
    # compat.from_jax
    load_vitvq_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _count_calls(monkeypatch, sites):
    """Count the calls of each (name, module, function) site."""
    calls = {name: 0 for name, _, _ in sites}
    for name, mod, fn in sites:
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    return calls


def _count_fused_calls(monkeypatch):
    return _count_calls(monkeypatch, (
        ("attn_proj", tatt, "attention_proj_plain"),
        ("ffn", tffn, "ffn_plain")))


@pytest.mark.parametrize("tower,image_size,batch,jax_kernels", [
    # fake_vitvq_tiny's towers: the JAX side takes its XLA twins (d 64 is
    # off the TPU kernels' 128-lane grid), the same function in f32
    (dict(dim=64, depth=2, heads=2, mlp_dim=128), 32, 4, set()),
    # imagenet_vitvq_small's widths at depth 2: JAX runs B15 and B16
    (dict(dim=512, depth=2, heads=8, mlp_dim=2048), 256, 1,
     {"attn_proj", "ffn"}),
    # ViT-VQGAN-Base widths at depth 2: JAX runs B15; its B16 takes
    # _ffn_xla, the f32 weights (18.9 MB) being over the kernel's 12 MB
    (dict(dim=768, depth=2, heads=12, mlp_dim=3072), 256, 1, {"attn_proj"}),
], ids=["tiny", "small-widths", "base-widths"])
def test_fused_round_trip_matches_jax(interpret, monkeypatch, tower,
                                      image_size, batch, jax_kernels):
    """Codes equal, reconstructions from them within f32 tolerance (1e-4:
    four GEMMs a block over up to 3072 terms, sums in another order), and
    every block on the fused branches (launch-free on the CPU: the plain
    versions' calls are counted). The JAX side dispatches 'auto' ops as
    on a TPU (``on_tpu`` patched in this test), so its Pallas kernels run
    interpreted where their TPU limits let them; their entries are
    counted as JAX traces them."""
    monkeypatch.setenv("ENHANCING_TPU_ATTN_PROJ", "1")
    monkeypatch.setattr(jcommon, "on_tpu", lambda: True)
    jm, tm = _fused_pair(tower, image_size)
    calls = _count_fused_calls(monkeypatch)
    traced = _count_calls(monkeypatch, (
        ("attn_proj", jatt, "_attention_proj_packed_call"),
        ("ffn", jffn, "_ffn_pallas")))
    x = np.random.default_rng(6).random((batch, image_size, image_size, 3),
                                        dtype=np.float32)
    codes = tm.encode_codes(x)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jm.encode_codes(x)))
    rec = tm.decode_codes(codes.numpy())
    np.testing.assert_allclose(rec.numpy(),
                               np.asarray(jm.decode_codes(codes.numpy())),
                               atol=1e-4, rtol=1e-4)
    depth = 2 * tower["depth"]
    assert calls == {"attn_proj": depth, "ffn": depth}
    assert {name for name, n in traced.items() if n} == jax_kernels


def test_fused_config_builds_through_load_config(monkeypatch):
    """An encoder/decoder block with ``ffn_impl: fused`` builds through the
    port's initialize_from_config, and its FFNs take the fused branch."""
    tower = dict(dim=64, depth=1, heads=2, mlp_dim=128, ffn_impl="fused")
    cfg = {"target": "enhancing_tpu_torch.models.stage1.vitvqgan.ViTVQ",
           "params": {"image_size": 32, "patch_size": 8, "encoder": tower,
                      "decoder": tower,
                      "quantizer": {"embed_dim": 16, "n_embed": 128}}}
    model = initialize_from_config(cfg, device="cpu")
    calls = _count_fused_calls(monkeypatch)
    model.decode_codes(model.encode_codes(np.zeros((1, 32, 32, 3),
                                                   np.float32)))
    assert calls == {"attn_proj": 0, "ffn": 2}
    assert model.module.encoder.transformer.layers_0.ff.ffn_impl == "fused"
