"""The port's int8 serving of the RQ prior against the JAX package's, on the
CPU: int8 weights (``quantize_decode_params``) and the int8 spatial cache
(``kv_int8``).

The JAX RQTransformer is built at ``configs/fake_rq_tiny.yaml`` widths from
a seed, in both parameter layouts (``scan_layers=True``: scanned
``spatial`` and ``depth`` stacks; ``False``: ``spatial_{i}`` and
``depth_{i}``); its parameters, nudged by seeded noise so that no bias is
zero, are quantised by the JAX package and carried across with their
``quant`` collection (``compat.load_rq_from_jax``). Inputs are made with
numpy from a seed. The port runs on ``device="cpu"``, so every op takes its
plain PyTorch version; f32 unless a test says otherwise, each tolerance
stated.
"""
import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage2 import RQTransformer as JaxRQ
from enhancing_tpu.models.stage2 import \
    quantize_decode_params as jax_quantize_decode_params
from enhancing_tpu.models.stage2 import sample_rq as jax_sample_rq
from enhancing_tpu_torch.compat import load_rq_from_jax
from enhancing_tpu_torch.models.stage2 import (RQTransformer,
                                               drop_quantized_kernels,
                                               quantize_decode_params,
                                               sample_rq)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
# configs/fake_rq_tiny.yaml's prior
TINY = dict(vocab_cond_size=1000, vocab_img_size=128, embed_dim=64,
            cond_num_tokens=1, img_num_tokens=16, depth_num_tokens=2,
            spatial_n_heads=2, depth_n_heads=2, spatial_n_layers=2,
            depth_n_layers=1)
# the int8 decode's fp32 products, summed in another order on each side
# (tests/test_torch_int8.py's limit for the GPT's int8 logits)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-5)
STEPS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _jax_variables(scan_layers):
    """The JAX prior at TINY widths and the variables of its
    ``quantize_decode_params`` (numpy leaves): parameters drawn from seed
    0 and nudged by seeded noise, and their ``quant`` collection."""
    jm = JaxRQ(**TINY, scan_layers=scan_layers)
    codes = jnp.zeros((1, TINY["img_num_tokens"], TINY["depth_num_tokens"]),
                      jnp.int32)
    conds = jnp.zeros((1, TINY["cond_num_tokens"]), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), codes, conds)["params"]
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)
    qvs = jax_quantize_decode_params({"params": params})
    return jax.tree_util.tree_map(np.asarray, qvs)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan_layers", "unrolled"])
def variables(request):
    return request.param, _jax_variables(request.param)


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, TINY["vocab_img_size"],
                         (b, TINY["img_num_tokens"], TINY["depth_num_tokens"])
                         ).astype(np.int32)
    conds = rng.integers(0, TINY["vocab_cond_size"], (b, 1)).astype(np.int32)
    return codes, conds


def test_rq_twins_equal_jax_quantize(variables):
    """The port's quantize_decode_params on the carried fp32 weights gives
    JAX's quant collection, loaded by load_rq_from_jax: one twin a GEMM of
    the spatial and depth stacks and the head, as JAX's _walk gives; the
    int8 weights equal; the scales equal but where XLA, compiling the JAX
    function under jit, turns amax / 127 into amax * fp32(1 / 127)
    (ROADMAP C): those entries are one ulp apart."""
    _, vs = variables
    loaded = load_rq_from_jax(RQTransformer(**TINY, device="cpu"), vs)
    ported = quantize_decode_params(
        load_rq_from_jax(RQTransformer(**TINY, device="cpu"), vs["params"]))
    n_twins = 0
    for name, dense in ported.named_modules():
        if getattr(dense, "weight_q", None) is None:
            continue
        n_twins += 1
        jax_twin = loaded.get_submodule(name)
        torch.testing.assert_close(dense.weight_q, jax_twin.weight_q, atol=0,
                                   rtol=0, msg=name)
        amax = dense.weight.abs().amax(dim=-1).clamp_min(1e-12)
        torch.testing.assert_close(dense.scale, amax / 127.0, atol=0, rtol=0)
        ulps = (dense.scale.view(torch.int32)
                - jax_twin.scale.view(torch.int32)).abs()
        assert int(ulps.max()) <= 1, name
    layers = TINY["spatial_n_layers"] + TINY["depth_n_layers"]
    assert n_twins == 6 * layers + 1  # q, k, v, proj, p0, p1; the head
    attn = loaded.spatial_1.attn
    assert attn.key.weight_q.data_ptr() == attn.qkv_q.data_ptr() + 64 * 64


def test_load_rq_quant_refuses_mismatches(variables):
    """A quant leaf with no twin, a twin with no leaf, and a leaf of the
    wrong shape raise, in either layout."""
    _, vs = variables
    extra = copy.deepcopy(vs)
    extra["quant"]["head"]["bogus"] = extra["quant"]["head"]["scale"]
    missing = copy.deepcopy(vs)
    del missing["quant"]["head"]["scale"]
    wrong = copy.deepcopy(vs)
    wrong["quant"]["head"]["scale"] = wrong["quant"]["head"]["scale"][:-1]
    for bad, exc in ((extra, KeyError), (missing, KeyError),
                     (wrong, ValueError)):
        with pytest.raises(exc):
            load_rq_from_jax(RQTransformer(**TINY, device="cpu"), bad)


def test_int8_spatial_cache_matches_jax(variables):
    """kv_int8 with int8 weights, teacher-forced on the same codes: the
    spatial hidden after the prefill and each of 3 spatial steps within
    LOGITS_TOL of JAX's; then the int8 cache (ctx padded to 128 on both
    sides) equal in its rows < 1 + 3 and zero past them, the per-row
    scales within 1e-5 relative (fp32 rows summed in each side's order,
    and XLA's amax * fp32(1 / 127) under jit), the shift state within
    LOGITS_TOL."""
    scan, vs = variables
    jm = JaxRQ(**TINY, scan_layers=scan, kv_int8=True)
    jvs = jax.tree_util.tree_map(jnp.asarray, vs)
    tm = load_rq_from_jax(RQTransformer(**TINY, kv_int8=True, device="cpu"),
                          vs)
    codes, conds = _inputs(seed=1)
    step = jax.jit(lambda c, s, cache: jm.apply(jvs, c, s, cache,
                                                method="spatial_step"))
    cache_j = jm.apply(jvs, 2, method="init_cache")
    hid_j, cache_j = jax.jit(lambda c, cache: jm.apply(
        jvs, c, cache, method="spatial_prefill"))(jnp.asarray(conds),
                                                  cache_j)
    with torch.inference_mode():
        cache_t = tm.init_cache(2)
        assert {k: tuple(v.shape) for k, v in cache_t.items()} == \
            {k: tuple(v.shape) for k, v in cache_j.items()}
        assert cache_t["k"].shape[2] == 128
        hid_t, cache_t = tm.spatial_prefill(_t(conds), cache_t)
        for pos in range(STEPS + 1):
            if pos:
                hid_j, cache_j = step(jnp.asarray(codes[:, pos - 1]),
                                      jnp.int32(pos), cache_j)
                hid_t, cache_t = tm.spatial_step(_t(codes[:, pos - 1]), pos,
                                                 cache_t)
            np.testing.assert_allclose(hid_t.float().numpy(),
                                       np.asarray(hid_j, np.float32),
                                       **LOGITS_TOL, err_msg=f"pos {pos}")
    rows = 1 + STEPS
    for name in ("k", "v"):
        assert cache_t[name].dtype == torch.int8
        np.testing.assert_array_equal(cache_t[name][:, :, :rows].numpy(),
                                      np.asarray(cache_j[name])[:, :, :rows],
                                      err_msg=name)
        assert not cache_t[name][:, :, rows:].any()
        scale = name + "_scale"
        np.testing.assert_allclose(cache_t[scale][:, :, :rows].numpy(),
                                   np.asarray(cache_j[scale])[:, :, :rows],
                                   rtol=1e-5, atol=0, err_msg=scale)
        assert not cache_t[scale][:, :, rows:].any()
    np.testing.assert_allclose(cache_t["shift"].float().numpy(),
                               np.asarray(cache_j["shift"], np.float32),
                               **LOGITS_TOL)


def test_int8_greedy_codes_equal_jax_sample_rq():
    """Greedy codes of the int8 prior with the int8 cache (scanned layout,
    the configs' default; JAX's sampler compiled once) equal JAX's
    sample_rq on the same quantised variables; without the int8 cache too
    (the same twins, a full-precision cache)."""
    vs = _jax_variables(True)
    jvs = jax.tree_util.tree_map(jnp.asarray, vs)
    _, conds = _inputs(seed=3)
    for kv_int8 in (True, False):
        jm = JaxRQ(**TINY, kv_int8=kv_int8)
        _, want = jax_sample_rq(jm, jvs, jnp.asarray(conds),
                                jax.random.PRNGKey(0), top_k=1)
        tm = load_rq_from_jax(RQTransformer(**TINY, kv_int8=kv_int8,
                                            device="cpu"), vs)
        _, codes = sample_rq(tm, _t(conds), torch.Generator().manual_seed(0),
                             top_k=1, with_logits=False)
        assert codes.shape == (2, 16, 2) and codes.dtype == torch.int32
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want),
                                      err_msg=f"kv_int8={kv_int8}")


def test_drop_quantized_kernels_refuses_the_rq_prior():
    """drop_quantized_kernels raises on an RQ prior (JAX's reason: its
    depth stack samples on the full-precision weights) before it frees
    anything; CondTransformer.sample then runs on the int8 prior and its
    int8 cache."""
    cfg = load_config(REPO / "configs" / "fake_rq_tiny.yaml").model.to_dict()
    cfg["params"]["transformer"]["params"]["kv_int8"] = True
    model = initialize_from_config(cfg, device="cpu")
    quantize_decode_params(model)
    weights = {n: p for n, p in model.transformer.named_parameters()}
    with pytest.raises(ValueError, match="RQTransformer.*depth_forward"):
        drop_quantized_kernels(model)
    assert {n: p for n, p in model.transformer.named_parameters()} == weights
    pixels, codes = model.sample(np.array([[3], [999]]), top_k=4,
                                 return_codes=True)
    assert codes.shape == (2, 16, 2) and pixels.shape == (2, 32, 32, 3)
    assert float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0
