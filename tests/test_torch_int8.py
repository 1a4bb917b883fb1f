"""The port's int8 serving of the GPT prior against the JAX package's, on
the CPU.

Op tests: inputs made with numpy from a seed go through the JAX Pallas
kernel in interpret mode (ENHANCING_TPU_PALLAS_INTERPRET=1) and through
the port's entry point on CPU tensors, which runs its plain version. The
shapes pass the JAX kernels' gates (d = 128, n = 256, h = 512, m = 8, an
int8 cache of 128 rows), so the Pallas kernel, not its XLA twin, is the
reference. Model tests: the tiny GPT of ``tests/test_stage2.py``'s int8
tests (embed 128, 4 heads, 2 layers, 16 codes), in both parameter
layouts, its parameters nudged by seeded noise so that no bias is zero,
quantised by the JAX package and carried across with its ``quant``
collection. f32 unless a test says otherwise; each tolerance stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage2 import GPT as JaxGPT
from enhancing_tpu.models.stage2 import \
    quantize_decode_params as jax_quantize_decode_params
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.ops import cache as jcache
from enhancing_tpu.ops import int8 as jint8
from enhancing_tpu.ops import ln_gemm as jlg
from enhancing_tpu_torch.compat import load_gpt_from_jax
from enhancing_tpu_torch.models.stage2 import (GPT, drop_quantized_kernels,
                                               quantize_decode_params,
                                               sample_gpt)
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.ops import cache as tcache
from enhancing_tpu_torch.ops import int8 as tint8
from enhancing_tpu_torch.ops import ln_gemm as tlg

# f32 with another summation order on each side
F32_TOL = dict(atol=2e-5, rtol=1e-5)
# bf16 outputs of the same fp32 sums: one bf16 step either way
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -8)
M, D, N, H = 8, 128, 256, 512


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ENHANCING_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.float().numpy()


def _ln(rng, shape):
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, gamma, beta


def _weight(rng, d, n):
    """A JAX (d, n) kernel quantised by the JAX package: (w_q, scale)."""
    w = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    w_q, scale = jint8.quantize_channelwise(jnp.asarray(w))
    return np.asarray(w_q), np.asarray(scale)


def _dt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _x(a, dtype):
    """(JAX array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(a, _dt(dtype))
    return j, _t(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(128, 256), (256, 384), (2, 128, 256)])
def test_quantize_channelwise_equals_jax(shape):
    """int8 values and scales equal to JAX's, entry for entry; the port
    takes (out, in), the JAX package (in, out)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3, :] = 0.0  # a row of zeros meets an all-zero channel
    w[..., 5, 7] = 2.5 * np.abs(w[..., :, 7]).max(-1)  # an exact 127
    want_q, want_s = jint8.quantize_channelwise(jnp.asarray(w))
    got_q, got_s = tint8.quantize_channelwise(_t(np.swapaxes(w, -1, -2)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(got_q.numpy(), -1, -2),
                                  np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,residual,activation", [
    (False, False, None), (True, False, None), (True, True, "sqrelu")])
def test_int8_gemm_matches_jax_kernel(interpret, dtype, bias, residual,
                                      activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w_q, scale = _weight(rng, D, N)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    xj, xt = _x(x, dtype)
    want = jint8._int8_gemm_pallas(
        xj, jnp.asarray(w_q), jnp.asarray(scale),
        jnp.asarray(b if bias else np.zeros(N, np.float32)),
        jnp.asarray(res) if residual else None, activation)
    got = tint8.int8_gemm(xt, _t(w_q.T), _t(scale), _t(b) if bias else None,
                          activation=activation,
                          residual=_t(res) if residual else None)
    assert got.shape == (M, N) and got.dtype == xt.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_ln_gemm_matches_jax_kernel(interpret, shift, bias):
    rng = np.random.default_rng(2)
    x, gamma, beta = _ln(rng, (M, D))
    tm = np.linspace(0.0, 1.0, D, dtype=np.float32)
    prev = rng.standard_normal((M, D)).astype(np.float32)
    w_q, scale = _weight(rng, D, N)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    want, want_xn = jint8._int8_ln_gemm_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(tm), jnp.asarray(prev), jnp.asarray(w_q),
        jnp.asarray(scale),
        jnp.asarray(b if bias else np.zeros(N, np.float32)), None, 1e-5,
        shift)
    got, xn = tint8.int8_ln_gemm(
        _t(x), _t(gamma), _t(beta), _t(tm) if shift else None,
        _t(prev) if shift else None, _t(w_q.T), _t(scale),
        _t(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(xn.numpy(), np.asarray(want_xn), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_mlp_decode_matches_jax_kernel(interpret, dtype, bias):
    rng = np.random.default_rng(3)
    x, gamma, beta = _ln(rng, (M, D))
    w0_q, s0 = _weight(rng, D, H)
    w1_q, s1 = _weight(rng, H, D)
    b0 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    z0, z1 = np.zeros(H, np.float32), np.zeros(D, np.float32)
    xj, xt = _x(x, dtype)
    want = jint8._int8_mlp_pallas(
        xj, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w0_q),
        jnp.asarray(s0), jnp.asarray(b0 if bias else z0), jnp.asarray(w1_q),
        jnp.asarray(s1), jnp.asarray(b1) if bias else None, xj, "sqrelu",
        1e-5)
    got = tint8.int8_mlp_decode(
        xt, _t(gamma), _t(beta), _t(w0_q.T), _t(s0), _t(b0) if bias else None,
        _t(w1_q.T), _t(s1), _t(b1) if bias else None, residual=xt)
    assert got.shape == (M, D) and got.dtype == xt.dtype
    # bf16: the hidden rounds to bf16 before W1 on both sides; a hidden
    # element on the other side of a rounding boundary moves the output
    # by up to 2^-8 of its term, so two bf16 steps
    tol = F32_TOL if dtype == "float32" else dict(atol=2.0 ** -7,
                                                  rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_fused_ln_shift_gemm_matches_jax_kernel(interpret, shift, w_dtype):
    """fp32 x, as the decode step gives it, against W in fp32 or bf16 (cast
    to x's dtype by both wrappers)."""
    rng = np.random.default_rng(4)
    x, gamma, beta = _ln(rng, (M, D))
    tm = np.linspace(0.0, 1.0, D, dtype=np.float32)
    prev = rng.standard_normal((M, D)).astype(np.float32)
    w = (rng.standard_normal((D, N)) / np.sqrt(D)).astype(np.float32)
    wj, _ = _x(w, w_dtype)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    want, want_xn = jlg._ln_shift_gemm_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(tm), jnp.asarray(prev), wj.astype(jnp.float32),
        jnp.asarray(b), "gelu", 1e-5, shift)
    got, xn = tlg.fused_ln_shift_gemm(
        _t(x), _t(gamma), _t(beta), _t(tm) if shift else None,
        _t(prev) if shift else None,
        _t(np.asarray(wj.astype(jnp.float32)).T).to(getattr(torch, w_dtype)),
        _t(b), activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(xn.numpy(), np.asarray(want_xn), **F32_TOL)


def _int8_stack(rng, layers, b, m, hd, cur):
    """Per-row quantised (L, B, M, HD) k, v stacks and their scales; rows
    past each row's cur_len hold the largest int8 and a scale of 1e6."""
    out = []
    dead = np.arange(m)[None, :] >= np.reshape(cur, (-1, 1))
    for _ in range(2):
        rows = rng.standard_normal((layers, b, m, hd)).astype(np.float32)
        q, sc = jcache_quant(rows)
        q[:, np.broadcast_to(dead, (b, m))] = 127
        sc[:, np.broadcast_to(dead, (b, m))] = 1e6
        out += [q, sc]
    return out


def jcache_quant(rows):
    q, sc = JaxGPT._quant_rows(jnp.asarray(rows))
    return np.array(q), np.array(sc)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("cur", [5, 128, 200, "ragged"])
def test_decode_attention_int8_cache_matches_jax(interpret, ref, cur):
    """The int8 cache's plain version (dequantise to q's dtype, then the
    f32 decode) against JAX's kernel and its twin."""
    layers, b, m, hd, head_dim, layer = 2, 3, 256, 256, 64, 1
    rng = np.random.default_rng(5)
    if cur == "ragged":
        cur = np.array([1, 128, 255], np.int32)
    kq, ks, vq, vs = _int8_stack(rng, layers, b, m, hd, cur)
    q3, kn, vn = (rng.standard_normal((b, hd)).astype(np.float32)
                  for _ in range(3))
    q3 *= np.float32(head_dim ** -0.5)
    cur_j = jnp.asarray(cur, jnp.int32)
    args = [jnp.asarray(a) for a in (q3, kq, vq, ks, vs, kn, vn)]
    if ref == "pallas":
        want = jatt._decode_pallas(args[0], args[1], args[2], args[5],
                                   args[6], cur_j, head_dim, block_k=128,
                                   layer=jnp.int32(layer), ks=args[3],
                                   vs=args[4])
    else:
        want = jatt.decode_attention_stacked(
            args[0], args[1], args[2], args[5], args[6], cur_j,
            jnp.int32(layer), head_dim=head_dim, k_scale=args[3],
            v_scale=args[4], impl="xla")
    got = tatt.decode_attention_stacked(
        _t(q3), _t(kq), _t(vq), _t(kn), _t(vn),
        cur if isinstance(cur, int) else _t(cur), layer, head_dim=head_dim,
        k_scale=_t(ks), v_scale=_t(vs))
    # the tolerance of the JAX package's own decode kernel test
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=2e-4)


def test_decode_attention_int8_cache_unstacked_is_the_stacked_layer():
    rng = np.random.default_rng(6)
    kq, ks, vq, vs = _int8_stack(rng, 1, 2, 64, 128, 17)
    q3, kn, vn = (_t(rng.standard_normal((2, 128)).astype(np.float32))
                  for _ in range(3))
    got = tatt.decode_attention(q3, _t(kq[0]), _t(vq[0]), kn, vn, 17,
                                head_dim=32, k_scale=_t(ks[0]),
                                v_scale=_t(vs[0]))
    want = tatt.decode_attention_stacked(q3, _t(kq), _t(vq), kn, vn, 17, 0,
                                         head_dim=32, k_scale=_t(ks),
                                         v_scale=_t(vs))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("cur", [0, 9, "ragged", "outside"])
def test_scale_row_update_matches_jax(cur):
    rng = np.random.default_rng(7)
    scales = rng.random((2, 4, 16)).astype(np.float32)
    news = rng.random((2, 4, 1)).astype(np.float32)
    if cur == "ragged":
        cur = np.array([0, 9, 15, 3], np.int32)
    elif cur == "outside":  # rows outside [0, ctx) are not written
        cur = np.array([-1, 16, 7, 40], np.int32)
    want = jcache.scale_row_update(jnp.asarray(scales), jnp.asarray(news),
                                   jnp.asarray(cur, jnp.int32))
    target = _t(scales.copy())
    got = tcache.scale_row_update(target, _t(news),
                                  cur if isinstance(cur, int) else _t(cur))
    assert got.data_ptr() == target.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the tiny GPT, quantised --------------------------------------------------

TINY = dict(vocab_cond_size=10, vocab_img_size=256, embed_dim=128,
            cond_num_tokens=1, img_num_tokens=16, n_heads=4, n_layers=2)
BATCH = 4
# f32 logits through two blocks and the head, the JAX package's XLA
# twins against the port's plain versions
LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)


def _variables(jm, seed=0):
    codes = jnp.zeros((1, TINY["img_num_tokens"]), jnp.int32)
    conds = jnp.zeros((1, 1), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), codes, conds)["params"]
    rng = np.random.default_rng(seed + 10)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    qvs = jax_quantize_decode_params({"params": params})
    return jax.tree_util.tree_map(np.asarray, qvs)


def _jax_greedy(jm, variables, conds, steps=15, codes=None):
    """JAX prefill + decode steps (jitted): greedy codes (argmax), or
    ``codes`` fed when given; returns (logits (B, 1 + steps, V), codes,
    final cache)."""
    vs = jax.tree_util.tree_map(jnp.asarray, variables)
    cache = jm.apply(vs, conds.shape[0], method="init_cache")
    logits, cache = jax.jit(lambda c, cache: jm.apply(
        vs, c, cache, method="prefill"))(jnp.asarray(conds), cache)
    step_fn = jax.jit(lambda tok, step, cache: jm.apply(
        vs, tok, step, cache, method="decode_step"))
    out, toks = [logits], [jnp.argmax(logits, -1)]
    for step in range(1, steps + 1):
        tok = toks[-1] if codes is None else jnp.asarray(codes[:, step - 1])
        logits, cache = step_fn(tok.astype(jnp.int32), jnp.int32(step), cache)
        out.append(logits)
        toks.append(jnp.argmax(logits, -1))
    return (np.stack([np.asarray(o) for o in out], 1),
            np.stack([np.asarray(t) for t in toks], 1).astype(np.int32),
            jax.tree_util.tree_map(np.asarray, cache))


def _port_teacher_forced(tm, conds, codes, steps=15):
    with torch.inference_mode():
        cache = tm.init_cache(conds.shape[0])
        logits, cache = tm.prefill(_t(conds), cache)
        out = [logits]
        for step in range(1, steps + 1):
            logits, cache = tm.decode_step(_t(codes[:, step - 1]), step,
                                           cache)
            out.append(logits)
    return torch.stack(out, 1).float().numpy(), cache


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan_layers", "unrolled"])
def int8_pair(request):
    jm = JaxGPT(**TINY, scan_layers=request.param)
    variables = _variables(jm)
    conds = np.array([[1], [3], [7], [9]], np.int32)
    logits, codes, _ = _jax_greedy(jm, variables, conds)
    return request.param, variables, conds, logits, codes


def test_int8_twins_equal_jax_quantize(int8_pair):
    """The port's quantize_decode_params on the carried fp32 weights gives
    JAX's quant collection: the int8 weights equal; the scales equal but
    where XLA, compiling the JAX function under jit, turns amax / 127 into
    amax * fp32(1 / 127) (ROADMAP C): those entries are one ulp apart, and
    JAX's equal the product exactly."""
    _, variables, *_ = int8_pair
    loaded = load_gpt_from_jax(GPT(**TINY, device="cpu"), variables)
    ported = quantize_decode_params(
        load_gpt_from_jax(GPT(**TINY, device="cpu"), variables["params"]))
    recip = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    n_twins = rewritten = 0
    for name, dense in ported.named_modules():
        if getattr(dense, "weight_q", None) is None:
            continue
        n_twins += 1
        jax_twin = loaded.get_submodule(name)
        torch.testing.assert_close(dense.weight_q, jax_twin.weight_q, atol=0,
                                   rtol=0, msg=name)
        amax = dense.weight.abs().amax(dim=-1).clamp_min(1e-12)
        torch.testing.assert_close(dense.scale, amax / 127.0, atol=0, rtol=0)
        torch.testing.assert_close(jax_twin.scale, amax * recip, atol=0,
                                   rtol=0, msg=name)
        ulps = (dense.scale.view(torch.int32)
                - jax_twin.scale.view(torch.int32)).abs()
        assert int(ulps.max()) <= 1, name
        rewritten += int((ulps > 0).sum())
    assert n_twins == 6 * TINY["n_layers"] + 1  # q, k, v, proj, p0, p1, head
    assert rewritten < 0.2 * (TINY["n_layers"] * 10 + 2) * TINY["embed_dim"]


def test_int8_decode_logits_match_jax(int8_pair):
    """Prefill + 15 decode steps on the JAX greedy codes: logits within
    1e-4 of JAX's; the first block's qkv twin is one buffer."""
    _, variables, conds, want, codes = int8_pair
    tm = load_gpt_from_jax(GPT(**TINY, device="cpu"), variables)
    attn = tm.blocks_0.attn
    assert attn.query.weight_q.data_ptr() == attn.qkv_q.data_ptr()
    got, _ = _port_teacher_forced(tm, conds, codes)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_int8_greedy_codes_match_jax_with_and_without_drop(int8_pair):
    _, variables, conds, _, want = int8_pair
    tm = load_gpt_from_jax(GPT(**TINY, device="cpu"), variables)
    _, codes = sample_gpt(tm, _t(conds), torch.Generator().manual_seed(0),
                          top_k=1)
    np.testing.assert_array_equal(codes.numpy(), want)
    freed = drop_quantized_kernels(tm)
    c, d = TINY["embed_dim"], TINY["vocab_img_size"]
    assert freed == 4 * (TINY["n_layers"] * 12 * c * c + c * d)
    assert all(p.dtype != torch.float32 or p.dim() != 2 or "emb" in n
               for n, p in tm.named_parameters())
    _, dropped = sample_gpt(tm, _t(conds), torch.Generator().manual_seed(0),
                            top_k=1)
    np.testing.assert_array_equal(dropped.numpy(), want)
    with pytest.raises(RuntimeError, match="drop_quantized_kernels"):
        tm(_t(want), _t(conds))


def test_int8_kv_cache_matches_jax(int8_pair):
    """kv_int8 with int8 weights: the cache's int8 rows (rows < ctx) equal
    JAX's after prefill + 15 greedy steps, their scales within 1e-5
    relative, and the codes equal."""
    scan, variables, conds, *_ = int8_pair
    jm = JaxGPT(**TINY, scan_layers=scan, kv_int8=True)
    _, want_codes, want_cache = _jax_greedy(jm, variables, conds)
    tm = load_gpt_from_jax(GPT(**TINY, kv_int8=True, device="cpu"),
                           variables)
    _, codes = sample_gpt(tm, _t(conds), torch.Generator().manual_seed(0),
                          top_k=1)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    _, cache = _port_teacher_forced(tm, conds, want_codes)
    ctx = tm.ctx_len
    assert cache["k"].dtype == torch.int8
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name][:, :, :ctx].numpy(),
                                      want_cache[name][:, :, :ctx],
                                      err_msg=name)
    # the scales are amax / 127 of fp32 rows that both sides sum in their
    # own order (and that XLA divides as amax * fp32(1 / 127) under jit,
    # ROADMAP C): a few ulps apart
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[name][:, :, :ctx].numpy(),
                                   want_cache[name][:, :, :ctx], rtol=1e-5,
                                   atol=0, err_msg=name)


def test_lnfuse_logits_match_jax(int8_pair, monkeypatch):
    """ENHANCING_TPU_DECODE_LNFUSE=all on the full-precision GPT (set before
    the JAX trace of a fresh module): teacher-forced logits within 1e-4."""
    scan, variables, conds, _, codes = int8_pair
    monkeypatch.setenv("ENHANCING_TPU_DECODE_LNFUSE", "all")
    jm = JaxGPT(**TINY, scan_layers=scan)
    want, *_ = _jax_greedy(jm, {"params": variables["params"]}, conds,
                           codes=codes)
    tm = load_gpt_from_jax(GPT(**TINY, device="cpu"), variables["params"])
    got, _ = _port_teacher_forced(tm, conds, codes)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_int8_serving_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="RQTransformer"):
        quantize_decode_params(torch.nn.Linear(4, 4))
    with pytest.raises(ValueError, match="RQTransformer"):
        drop_quantized_kernels(torch.nn.Linear(4, 4))
    with pytest.raises(NotImplementedError, match="W8A8"):
        GPT(**TINY, act_int8=True, device="cpu")


def test_qkv_parameters_are_row_blocks_of_the_fused_qkv():
    """The LNFUSE qkv site reads one (3C, C) weight and (3C,) bias whose row
    blocks the query, key and value parameters are: a write to one shows
    there, a replaced parameter is tied again (one copy), and
    drop_quantized_kernels releases the weight."""
    tm = GPT(**TINY, device="cpu")
    attn, c = tm.blocks_1.attn, TINY["embed_dim"]
    w, b = attn.fused_qkv("weight"), attn.fused_qkv("bias")
    assert w.shape == (3 * c, c) and b.shape == (3 * c,)
    for i, dense in enumerate((attn.query, attn.key, attn.value)):
        assert dense.weight.data_ptr() == w[i * c].data_ptr()
        assert dense.bias.data_ptr() == b[i * c:].data_ptr()
    with torch.no_grad():
        attn.key.weight.add_(1.0)
    assert attn.fused_qkv("weight") is w
    torch.testing.assert_close(w[c:2 * c], attn.key.weight, atol=0, rtol=0)
    new = torch.randn(c, c)
    attn.value.weight = torch.nn.Parameter(new.clone())
    w2 = attn.fused_qkv("weight")
    assert w2 is not w and attn.value.weight.data_ptr() == w2[2 * c].data_ptr()
    torch.testing.assert_close(w2[2 * c:], new, atol=0, rtol=0)
    torch.testing.assert_close(w2[:c], attn.query.weight, atol=0, rtol=0)
    drop_quantized_kernels(quantize_decode_params(tm))
    assert attn.fused_qkv("weight") is None and not attn.qkv_tied.get("weight")
    assert attn.fused_qkv("bias") is b
