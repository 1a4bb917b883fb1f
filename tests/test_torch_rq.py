"""The port's RQ prior (RQTransformer, sample_rq, CondTransformer's RQ
branch) and the attention's short route against the JAX package, on the
CPU.

The JAX RQTransformer is built at ``configs/fake_rq_tiny.yaml`` widths
from a seed, in both parameter layouts (``scan_layers=True``: scanned
``spatial`` and ``depth`` stacks; ``False``: ``spatial_{i}`` and
``depth_{i}``); its parameters, nudged by seeded noise so that no bias is
zero, are carried into the port with ``compat.load_rq_from_jax``. Inputs
are made with numpy from a seed. The port runs on ``device="cpu"``, so
every op takes its plain PyTorch version; f32, each tolerance stated.
"""
import copy
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage2 import RQTransformer as JaxRQ
from enhancing_tpu.models.stage2.transformer import \
    CondTransformer as JaxCondTransformer
from enhancing_tpu.models.stage2 import sample_rq as jax_sample_rq
from enhancing_tpu.ops.attention import _attention_xla_bnhd
from enhancing_tpu.utils.config import initialize_from_config as jax_init
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import load_rq_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.models.stage2 import (CondTransformer,
                                               RQTransformer, sample_rq)
from enhancing_tpu_torch.ops import attention as att
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
# configs/fake_rq_tiny.yaml's prior
TINY = dict(vocab_cond_size=1000, vocab_img_size=128, embed_dim=64,
            cond_num_tokens=1, img_num_tokens=16, depth_num_tokens=2,
            spatial_n_heads=2, depth_n_heads=2, spatial_n_layers=2,
            depth_n_layers=1)
# f32 through a few blocks, another summation order on each side
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_params(module, seed=0):
    codes = jnp.zeros((1, module.img_num_tokens, module.depth_num_tokens),
                      jnp.int32)
    conds = jnp.zeros((1, module.cond_num_tokens), jnp.int32)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), codes,
                                  conds)["params"]
    rng = np.random.default_rng(seed + 10)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _jax_prior(scan_layers):
    """The JAX prior at TINY widths and its nudged parameters, built once
    for the module (the CondTransformer test reuses the scanned one)."""
    jm = JaxRQ(**TINY, scan_layers=scan_layers)
    return jm, _jax_params(jm)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan_layers", "unrolled"])
def pair(request):
    jm, params = _jax_prior(request.param)
    tm = load_rq_from_jax(RQTransformer(**TINY, device="cpu"), params)
    return jm, {"params": params}, tm


def _inputs(b=3, seed=0, kw=TINY):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, kw["vocab_img_size"],
                         (b, kw["img_num_tokens"], kw["depth_num_tokens"])
                         ).astype(np.int32)
    conds = rng.integers(0, kw["vocab_cond_size"], (b, 1)).astype(np.int32)
    return codes, conds


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_forward_matches_jax(pair):
    jm, vs, tm = pair
    codes, conds = _inputs()
    want = jax.jit(jm.apply)(vs, jnp.asarray(codes), jnp.asarray(conds))
    with torch.inference_mode():
        got = tm(_t(codes), _t(conds))
    assert got.shape == (3 * 16, 2, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_spatial_prefill_step_and_depth_forward_match_jax(pair):
    """Teacher-forced on the same codes: the prefill's hidden and cache
    rows, each spatial step's hidden, cache rows and shift state, and
    depth_forward's logits at every depth d (codes past d garbage, masked
    on both sides)."""
    jm, vs, tm = pair
    codes, conds = _inputs(b=2, seed=1)
    step = jax.jit(lambda c, s, cache: jm.apply(vs, c, s, cache,
                                                method="spatial_step"))
    depth = jax.jit(lambda h, c, d: jm.apply(vs, h, c, d,
                                             method="depth_forward"))
    cache_j = jm.apply(vs, 2, method="init_cache")
    hid_j, cache_j = jax.jit(lambda c, cache: jm.apply(
        vs, c, cache, method="spatial_prefill"))(jnp.asarray(conds), cache_j)
    with torch.inference_mode():
        cache_t = tm.init_cache(2)
        hid_t, cache_t = tm.spatial_prefill(_t(conds), cache_t)
        for name in ("k", "v", "shift"):
            assert cache_t[name].shape == cache_j[name].shape
        for pos in range(3):
            if pos:
                hid_j, cache_j = step(jnp.asarray(codes[:, pos - 1]),
                                      jnp.int32(pos), cache_j)
                hid_t, cache_t = tm.spatial_step(_t(codes[:, pos - 1]), pos,
                                                 cache_t)
            np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                                       **F32_TOL)
            rows = 1 + pos  # cond_num_tokens + pos rows written
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    cache_t[name][:, :, :rows].numpy(),
                    np.asarray(cache_j[name])[:, :, :rows], **F32_TOL)
                assert not cache_t[name][:, :, rows:].any()
            np.testing.assert_allclose(cache_t["shift"].numpy(),
                                       np.asarray(cache_j["shift"]),
                                       **F32_TOL)
            for d in range(TINY["depth_num_tokens"]):
                dc = codes[:, pos].copy()
                dc[:, d:] = 127 - d  # masked out on both sides
                want = depth(hid_j, jnp.asarray(dc), jnp.int32(d))
                got = tm.depth_forward(hid_t, _t(dc), d)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **F32_TOL)


def test_greedy_sample_codes_equal_jax(pair):
    """Greedy codes: each the argmax of JAX's teacher-forced logits on
    them, and, in the scanned layout (the configs' default), equal to
    JAX's sampler's (compiled once: the unrolled layout's loading is held
    by the forward and step tests)."""
    jm, vs, tm = pair
    _, conds = _inputs(b=2, seed=3)
    logits, codes = sample_rq(tm, _t(conds), torch.Generator().manual_seed(0),
                              top_k=1)
    assert codes.dtype == torch.int32 and codes.shape == (2, 16, 2)
    assert logits.shape == (2 * 16, 2, 128) and logits.dtype == torch.float32
    forced = jax.jit(jm.apply)(vs, jnp.asarray(codes.numpy()),
                               jnp.asarray(conds))
    np.testing.assert_array_equal(
        np.asarray(forced).argmax(-1).reshape(2, 16, 2), codes.numpy())
    if jm.scan_layers:
        _, want = jax_sample_rq(jm, vs, jnp.asarray(conds),
                                jax.random.PRNGKey(0), top_k=1)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    # the sampler's logits are the teacher-forced forward's on its codes
    with torch.inference_mode():
        full = tm(codes, _t(conds))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **F32_TOL)
    none, again = sample_rq(tm, _t(conds), torch.Generator().manual_seed(0),
                            top_k=1, with_logits=False)
    assert none is None and torch.equal(again, codes)


# a depth window of 4 tokens at head dim 192 (width 384, 2 depth heads), the
# shipped RQ prior's depth attention; the spatial heads of 96 run the plain
# version of B8 on the CPU
WIDE = dict(vocab_cond_size=10, vocab_img_size=64, embed_dim=384,
            cond_num_tokens=1, img_num_tokens=4, depth_num_tokens=4,
            spatial_n_heads=4, depth_n_heads=2, spatial_n_layers=1,
            depth_n_layers=1)


def test_depth_stack_at_head_dim_192_matches_jax():
    """The short route's plain version (the scale on the fp32 scores)
    against JAX's _attention_xla_bnhd at 4 tokens of head dim 192, alone
    and through a depth stack at width 384."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((3, 4, 2, 192)).astype(np.float32)
               for _ in range(3))
    want = _attention_xla_bnhd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 192 ** -0.5, "prefix_causal",
                               0)
    got = att.multihead_attention_bnhd(_t(q), _t(k), _t(v),
                                       mask_mode="prefix_causal")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    jm = JaxRQ(**WIDE, scan_layers=False)
    params = _jax_params(jm, seed=2)
    tm = load_rq_from_jax(RQTransformer(**WIDE, device="cpu"), params)
    codes, conds = _inputs(b=2, seed=6, kw=WIDE)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(codes),
                             jnp.asarray(conds))
    with torch.inference_mode():
        got = tm(_t(codes), _t(conds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_bnhd_route(dtype):
    """Fewer than 8 tokens at a head dim no kernel takes go to the short
    route; 8 or more raise (queue B); the head dims the kernels take run
    them at every length."""
    assert att.attention_bnhd_route(dtype, 192, 4) == ("short", None)
    assert att.attention_bnhd_route(dtype, 100, 1) == ("short", None)
    for n in (8, 1025):
        with pytest.raises(ValueError, match="queue B"):
            att.attention_bnhd_route(dtype, 192, n)
    fwd = "attn_fwd_kernel" if dtype == torch.bfloat16 else \
        "attn_f32_fwd_kernel"
    wide = "attn_wide_kernel" if dtype == torch.bfloat16 else \
        "attn_f32_wide_kernel"
    for n in (1, 4, 7, 8, 1025):
        assert att.attention_bnhd_route(dtype, 96, n) == (fwd, 128)
        assert att.attention_bnhd_route(dtype, 64, n) == (fwd, 64)
        assert att.attention_bnhd_route(dtype, 384, n) == (wide, 384)
    with pytest.raises(TypeError):
        att.attention_bnhd_route(torch.float16, 64, 4)


@pytest.fixture(scope="module")
def cond_pair():
    """fake_rq_tiny built by the port's config; on the JAX side its
    CondTransformer, whose condition model and stage-1 RQ-VAE are built
    from the same config and whose prior is the module's scanned TINY
    prior (the config's own widths and layout, its parameters from the
    jitted init instead of the constructor's eager one); the prior and the
    stage-1 RQ-VAE carried across."""
    cfg = jax_load_config(REPO / "configs" / "fake_rq_tiny.yaml").model
    prior = cfg.params.transformer
    assert prior.target.endswith(".RQTransformer")
    assert dict(prior.params) == TINY
    jm = object.__new__(JaxCondTransformer)
    jm.cond_key, jm.code_shape, jm.scheduler = cfg.params.cond_key, None, None
    assert "code_shape" not in cfg.params and "scheduler" not in cfg.params
    jm.cond_model = jax_init(cfg.params.cond)
    jm.stage1_model = jax_init(cfg.params.stage1)
    jm.transformer, jm.params = _jax_prior(True)
    jm.is_rq = True
    tm = initialize_from_config(
        load_config(REPO / "configs" / "fake_rq_tiny.yaml").model,
        device="cpu")
    load_rq_from_jax(tm, jm.params)
    load_vitvq_from_jax(tm.stage1_model, jax.tree_util.tree_map(
        np.asarray, jm.stage1_model.params))
    return jm, tm


def test_cond_transformer_rq_sample_and_loss_match_jax(cond_pair):
    """Greedy codes equal and pixels within f32 tolerance; the loss on a
    batch's (B * T, D) targets equal to JAX's."""
    jm, tm = cond_pair
    assert isinstance(tm, CondTransformer) and tm.is_rq
    assert isinstance(tm.transformer, RQTransformer)
    conds = np.array([[3], [999]], np.int32)
    want_pix, want_codes = jm.sample(conds, top_k=1, return_codes=True)
    pix, codes = tm.sample(conds, top_k=1, return_codes=True)
    assert codes.shape == (2, 16, 2) and pix.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert float(pix.min()) >= 0.0 and float(pix.max()) <= 1.0
    np.testing.assert_allclose(pix.numpy(), np.asarray(want_pix), atol=2e-5,
                               rtol=1e-5)
    rng = np.random.default_rng(8)
    batch = {"image": rng.random((2, 32, 32, 3), dtype=np.float32),
             "class": np.array([5, 17])}
    logits, targets = tm(*tm.encode_inputs(batch))
    assert logits.shape == (32, 2, 128) and targets.shape == (32, 2)
    want = float(jm.shared_step(batch))
    got = float(tm.shared_step(batch).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loader_refuses_mismatches(pair):
    params = pair[1]["params"]
    with pytest.raises(KeyError):  # a JAX block with no counterpart
        load_rq_from_jax(RQTransformer(**{**TINY, "spatial_n_layers": 1},
                                       device="cpu"), params)
    with pytest.raises(KeyError):  # a port block left unfilled
        load_rq_from_jax(RQTransformer(**{**TINY, "depth_n_layers": 2},
                                       device="cpu"), params)
    with pytest.raises(ValueError):
        load_rq_from_jax(RQTransformer(**{**TINY, "depth_num_tokens": 3},
                                       device="cpu"), params)
    with pytest.raises(KeyError, match="no JAX quant leaf"):
        # a quant collection without the twins' leaves
        load_rq_from_jax(RQTransformer(**TINY, device="cpu"),
                         {"params": params, "quant": {}})


def test_chip_smoke_holds_the_rq_configs():
    """chip_smoke.py holds configs/imagenet_rqtransformer_base.yaml (less
    the stage-1 checkpoint path) and imagenet_rqvae_base.yaml's model (its
    loss DummyLoss, as the prior's stage 1 holds it) as dicts: the card's
    machine has no pyyaml."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    prior = load_config(REPO / "configs" /
                        "imagenet_rqtransformer_base.yaml").to_dict()["model"]
    assert prior["params"]["stage1"]["params"].pop("path") == \
        "weight/imagenet_rqvae_base.ckpt"
    assert smoke.RQ_TRANSFORMER_BASE == prior
    rqvae = load_config(REPO / "configs" /
                        "imagenet_rqvae_base.yaml").to_dict()["model"]
    rqvae["params"]["loss"] = copy.deepcopy(
        prior["params"]["stage1"]["params"]["loss"])
    assert smoke.RQVAE_BASE == rqvae
    assert smoke.RQ_PRIOR["embed_dim"] // smoke.RQ_PRIOR["depth_n_heads"] \
        == 192
