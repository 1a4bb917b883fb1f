"""The port's stage-2 GPT prior, sampler and CondTransformer against the
JAX package's, on the CPU.

The JAX GPT is built at ``configs/fake_gpt_tiny.yaml`` widths from a seed,
in both parameter layouts (``scan_layers=True``: stacked ``blocks``;
``False``: ``blocks_{i}``); its parameters, nudged by seeded noise so that
no bias or position embedding is zero, are carried into the port with
``compat.load_gpt_from_jax``. Inputs are made with numpy from a seed. The
port runs on ``device="cpu"``, so every op takes its plain PyTorch
version; f32 unless a test says otherwise, each tolerance stated.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage2 import GPT as JaxGPT
from enhancing_tpu.models.stage2 import filter_logits as jax_filter_logits
from enhancing_tpu.models.stage2 import sample_gpt as jax_sample_gpt
from enhancing_tpu.utils.config import initialize_from_config as jax_init
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import load_gpt_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.models.stage1.vitvqgan import ViTVQ
from enhancing_tpu_torch.models.stage2 import (GPT, CondTransformer,
                                               filter_logits, sample_gpt)
from enhancing_tpu_torch.models.cond import ClassCond
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
# configs/fake_gpt_tiny.yaml's prior
TINY = dict(vocab_cond_size=1000, vocab_img_size=128, embed_dim=64,
            cond_num_tokens=1, img_num_tokens=16, n_heads=2, n_layers=2)
# f32 through two blocks, another summation order on each side
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_params(module, seed=0):
    codes = jnp.zeros((1, module.img_num_tokens), jnp.int32)
    conds = jnp.zeros((1, module.cond_num_tokens), jnp.int32)
    params = module.init(jax.random.PRNGKey(seed), codes, conds)["params"]
    rng = np.random.default_rng(seed + 10)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan_layers", "unrolled"])
def pair(request):
    jm = JaxGPT(**TINY, scan_layers=request.param)
    params = _jax_params(jm)
    tm = load_gpt_from_jax(GPT(**TINY, device="cpu"), params)
    return jm, params, tm


def _inputs(b=3, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, TINY["vocab_img_size"], (b, 16)).astype(np.int32)
    conds = rng.integers(0, TINY["vocab_cond_size"], (b, 1)).astype(np.int32)
    return codes, conds


def _port_decode(tm, codes, conds):
    """Prefill + teacher-forced decode steps of the port: (B, T, V)."""
    with torch.inference_mode():
        cache = tm.init_cache(codes.shape[0])
        logits, cache = tm.prefill(torch.from_numpy(conds), cache)
        out = [logits]
        for step in range(1, codes.shape[1]):
            logits, cache = tm.decode_step(
                torch.from_numpy(codes[:, step - 1]), step, cache)
            out.append(logits)
    return torch.stack(out, 1).numpy()


def test_full_forward_matches_jax(pair):
    jm, params, tm = pair
    codes, conds = _inputs()
    want = jm.apply({"params": params}, jnp.asarray(codes), jnp.asarray(conds))
    with torch.inference_mode():
        out = tm(torch.from_numpy(codes), torch.from_numpy(conds))
    assert out.shape == (3, 16, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)


def test_cached_decode_matches_jax_and_full_forward(pair):
    jm, params, tm = pair
    codes, conds = _inputs(seed=1)
    vs = {"params": params}
    cache = jm.apply(vs, 3, method="init_cache")
    logits, cache = jm.apply(vs, jnp.asarray(conds), cache, method="prefill")
    decode_step = jax.jit(lambda tok, step, cache: jm.apply(
        vs, tok, step, cache, method="decode_step"))
    want = [logits]
    for step in range(1, 16):
        logits, cache = decode_step(jnp.asarray(codes[:, step - 1]),
                                    jnp.int32(step), cache)
        want.append(logits)
    got = _port_decode(tm, codes, conds)
    np.testing.assert_allclose(got, np.stack(want, 1), **F32_TOL)
    with torch.inference_mode():
        full = tm(torch.from_numpy(codes), torch.from_numpy(conds)).numpy()
    np.testing.assert_allclose(got, full, **F32_TOL)


def test_ragged_decode_step_matches_lockstep(pair):
    """Per-row positions (a (B,) step) through the plain decode attention
    and row write: each row equals the lockstep run at its own step."""
    _, _, tm = pair
    codes, conds = _inputs(b=2, seed=2)
    lock = _port_decode(tm, codes, conds)
    with torch.inference_mode():
        cache = tm.init_cache(2)
        _, cache = tm.prefill(torch.from_numpy(conds), cache)
        # row 0 runs two steps ahead of row 1
        for step in (1, 2):
            _, cache = tm.decode_step(
                torch.from_numpy(codes[:1, step - 1]).repeat(2), step, cache)
        cache["k"][:, 1, 1:] = 0
        cache["v"][:, 1, 1:] = 0
        c1 = tm.init_cache(1)
        _, c1 = tm.prefill(torch.from_numpy(conds[1:]), c1)
        cache["shift"][:, 1] = c1["shift"][:, 0]
        steps = torch.tensor([3, 1], dtype=torch.int32)
        tokens = torch.tensor([codes[0, 2], codes[1, 0]], dtype=torch.int32)
        logits, cache = tm.decode_step(tokens, steps, cache)
    np.testing.assert_allclose(logits[0].numpy(), lock[0, 3], **F32_TOL)
    np.testing.assert_allclose(logits[1].numpy(), lock[1, 1], **F32_TOL)


def test_greedy_sample_codes_equal_jax(pair):
    jm, params, tm = pair
    _, conds = _inputs(b=4, seed=3)
    _, want = jax_sample_gpt(jm, {"params": params}, jnp.asarray(conds),
                             jax.random.PRNGKey(0), top_k=1)
    logits, codes = sample_gpt(tm, torch.from_numpy(conds),
                               torch.Generator().manual_seed(0), top_k=1)
    assert codes.dtype == torch.int32 and codes.shape == (4, 16)
    assert logits.shape == (4, 16, 128) and logits.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    _, no_logits = sample_gpt(tm, torch.from_numpy(conds),
                              torch.Generator().manual_seed(0), top_k=1,
                              with_logits=False)
    assert _ is None
    np.testing.assert_array_equal(no_logits.numpy(), codes.numpy())


def test_sampling_draws_from_the_filtered_distribution():
    """Seeded draws differ between seeds, repeat within one, and never
    leave the top-k set."""
    tm = GPT(**TINY, device="cpu", seed=3)
    conds = torch.tensor([[1], [2]])
    draw = lambda s: sample_gpt(tm, conds, torch.Generator().manual_seed(s),  # noqa: E731
                                top_k=5, top_p=0.9)
    logits, a = draw(0)
    _, b = draw(0)
    _, c = draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (top5 == a[..., None].long()).any(-1).all()


@pytest.mark.parametrize("top_k,top_p", [(7, None), (None, 0.8),
                                         (50, 0.95), (1, None)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = (np.random.default_rng(4).standard_normal((4, 128)) * 2.0
              ).astype(np.float32)
    want = jax_filter_logits(jnp.asarray(logits), top_k, top_p)
    got = filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))
    keep = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[keep], np.asarray(want)[keep])


def test_bf16_logits_near_jax_and_residual_fp32():
    """bf16 compute from the same fp32 parameters. Both round q/k/v, the
    token shift and every GEMM output to bf16, but at other places (flax
    adds the Dense bias after rounding the product, XLA may keep fp32
    between fused elementwise ops, JAX's CPU attention scales the fp32
    scores where the port scales q in bf16): logits within 2^-4 of the
    largest; the residual stream stays fp32."""
    jm = JaxGPT(**TINY, dtype=jnp.bfloat16, scan_layers=False)
    params = _jax_params(jm, seed=5)
    tm = load_gpt_from_jax(GPT(**TINY, dtype="bfloat16", device="cpu"),
                           params)
    codes, conds = _inputs(seed=6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(codes),
                               jnp.asarray(conds)).astype(jnp.float32))
    with torch.inference_mode():
        x = tm.embed_input(torch.from_numpy(codes), torch.from_numpy(conds))
        assert x.dtype == torch.float32
        for block in tm.blocks:
            x = block(x)
            assert x.dtype == torch.float32
        out = tm.project_out(x)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - want).max()
    assert err <= 2.0 ** -4 * np.abs(want).max(), err
    # the GEMM weights are stored in bf16 (JAX's fp32 values rounded once,
    # as flax casts them at each use); what the JAX module reads in fp32
    # (embeddings, position embeddings, LayerNorms, time_mix) stays fp32
    for name, p in tm.named_parameters():
        owner = name.rsplit(".", 1)[0].rsplit(".", 1)[-1]
        gemm = owner in ("query", "key", "value", "proj", "p0", "p1", "head")
        assert p.dtype == (torch.bfloat16 if gemm else torch.float32), name


@pytest.fixture(scope="module")
def cond_pair():
    """fake_gpt_tiny built by both packages' configs, the prior and the
    stage-1 tokenizer carried across."""
    cfg = jax_load_config(REPO / "configs" / "fake_gpt_tiny.yaml")
    jm = jax_init(cfg.model)
    tm = initialize_from_config(
        load_config(REPO / "configs" / "fake_gpt_tiny.yaml").model,
        device="cpu")
    load_gpt_from_jax(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    load_vitvq_from_jax(tm.stage1_model, jax.tree_util.tree_map(
        np.asarray, jm.stage1_model.params))
    return jm, tm


def test_cond_transformer_sample_matches_jax(cond_pair):
    """Greedy codes equal and pixels within f32 tolerance."""
    jm, tm = cond_pair
    assert isinstance(tm, CondTransformer)
    assert isinstance(tm.cond_model, ClassCond)
    assert isinstance(tm.stage1_model, ViTVQ)
    conds = np.array([[3], [7], [999]], np.int32)
    want_pix, want_codes = jm.sample(conds, top_k=1, return_codes=True)
    pix, codes = tm.sample(conds, top_k=1, return_codes=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert pix.shape == (3, 32, 32, 3)
    assert float(pix.min()) >= 0.0 and float(pix.max()) <= 1.0
    np.testing.assert_allclose(pix.numpy(), np.asarray(want_pix), atol=2e-5,
                               rtol=1e-5)


def test_cond_transformer_loss_matches_jax(cond_pair):
    jm, tm = cond_pair
    rng = np.random.default_rng(8)
    batch = {"image": rng.random((2, 32, 32, 3), dtype=np.float32),
             "class": np.array([5, 17])}
    want = float(jm.shared_step(batch))
    got = float(tm.shared_step(batch).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="vocab_cond_size"):
        tm.encode_inputs({"image": batch["image"],
                          "class": np.array([5, 1000])})


def test_flagship_config_builds_shrunk():
    """configs/imagenet_gpt_vitvq_base.yaml through the port's loader, with
    its widths cut (never the 11 G-parameter prior on the CPU) and its
    checkpoint path dropped."""
    cfg = load_config(REPO / "configs" / "imagenet_gpt_vitvq_base.yaml")
    params = cfg.model.params
    assert cfg.model.target == \
        "enhancing_tpu_torch.models.stage2.transformer.CondTransformer"
    tparams = params.transformer.params
    assert (tparams.embed_dim, tparams.n_layers, tparams.n_heads) == \
        (6144, 24, 16)
    tparams.update(embed_dim=32, n_layers=1, n_heads=2, img_num_tokens=16)
    s1 = params.stage1.params
    del s1["path"]
    tower = dict(dim=32, depth=1, heads=2, mlp_dim=64)
    s1.update(image_size=32, encoder=tower, decoder=tower)
    model = initialize_from_config(cfg.model, device="cpu")
    gpt = model.transformer
    assert (gpt.vocab_cond_size, gpt.vocab_img_size, gpt.ctx_len) == \
        (1000, 8192, 17)
    assert model.cond_model.num_classes >= 1000
    pix = model.sample(np.array([[1]]), top_k=4)
    assert pix.shape == (1, 32, 32, 3)


def test_refused_options_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        GPT(**TINY, act_int8=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        GPT(**TINY, sp_mesh=object(), device="cpu")
    cfg = load_config(REPO / "configs" / "fake_gpt_tiny.yaml").model
    rq = copy.deepcopy(cfg.to_dict())
    rq["params"]["transformer"]["target"] = \
        "enhancing_tpu_torch.models.stage2.layers.RQTransformer"
    with pytest.raises(NotImplementedError, match="A5"):
        initialize_from_config(rq, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        initialize_from_config(cfg, device="cpu", path="x.ckpt")
    model = initialize_from_config(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        model.sample(np.array([[1]]), mesh=object())


def test_decode_lnfuse_raises(monkeypatch):
    """ENHANCING_TPU_DECODE_LNFUSE names sites of qkv, mlp and head (or
    all / none); an unknown site raises at the decode step."""
    tm = GPT(**TINY, device="cpu")
    cache = tm.init_cache(1)
    monkeypatch.setenv("ENHANCING_TPU_DECODE_LNFUSE", "qkv,bogus")
    with pytest.raises(ValueError, match="bogus"):
        tm.decode_step(torch.tensor([1]), 1, cache)


@pytest.mark.parametrize("sites", ["qkv", "mlp", "head", "qkv,head", "all"])
def test_decode_lnfuse_sites_give_the_default_logits(pair, monkeypatch,
                                                     sites):
    """Each LNFUSE site computes the default path's function: f32 logits
    within the f32 tolerance of the unfused decode."""
    _, _, tm = pair
    codes, conds = _inputs(b=2, seed=11)
    want = _port_decode(tm, codes, conds)
    monkeypatch.setenv("ENHANCING_TPU_DECODE_LNFUSE", sites)
    np.testing.assert_allclose(_port_decode(tm, codes, conds), want,
                               **F32_TOL)


def test_loader_takes_the_quant_collection_of_either_layout():
    """A quant tree without params raises; the variables of the JAX
    quantize_decode_params fill the twins (test_torch_int8 holds them to
    JAX)."""
    from enhancing_tpu.models.stage2 import \
        quantize_decode_params as jax_quantize
    for scan in (True, False):
        jm = JaxGPT(**TINY, scan_layers=scan)
        qvs = jax.tree_util.tree_map(
            np.asarray, jax_quantize({"params": _jax_params(jm)}))
        tm = load_gpt_from_jax(GPT(**TINY, device="cpu"), qvs)
        assert tm.head.weight_q.shape == (128, 64)
        assert tm.blocks_1.attn.qkv_q.shape == (192, 64)
    with pytest.raises(KeyError):
        load_gpt_from_jax(GPT(**TINY, device="cpu"), {"quant": {}})


def test_loader_refuses_mismatches():
    jm = JaxGPT(**TINY, scan_layers=False)
    params = _jax_params(jm)
    with pytest.raises(KeyError):
        load_gpt_from_jax(GPT(**{**TINY, "n_layers": 1}, device="cpu"),
                          params)
    with pytest.raises(ValueError):
        load_gpt_from_jax(GPT(**{**TINY, "embed_dim": 32}, device="cpu"),
                          params)


def test_chip_smoke_holds_the_prior_config():
    """chip_smoke.py holds configs/imagenet_gpt_vitvq_base.yaml as a dict
    (the card's machine has no pyyaml), less the stage-1 checkpoint path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = load_config(REPO / "configs" /
                       "imagenet_gpt_vitvq_base.yaml").to_dict()["model"]
    assert want["params"]["stage1"]["params"].pop("path") == \
        "weight/imagenet_vitvq_base.ckpt"
    assert smoke.GPT_VITVQ_BASE == want
