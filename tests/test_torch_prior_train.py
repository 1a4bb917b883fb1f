"""Training the stage-2 GPT prior with the port, against the JAX package,
on the CPU.

- The differentiable (B, N, H, D) attention entry: gradients of the port's
  ``multihead_attention_bnhd`` (autograd of its plain version here; on
  CUDA B8 forward and B5 backward, at D = 384 ``csrc/attention_bwd_wide.cu``)
  against ``jax.vjp`` of the JAX function, at the prior's head dim 384
  and at 64 and 32, and at the RQ prior's 96 (spatial) and 192 on 4
  tokens (its depth window), both masks, fp32 and bf16.
- The prior's train and eval steps against ``make_cond_transformer_train_step``
  / ``make_cond_transformer_eval_step`` (``tests/test_train.py``'s tiny
  prior over a tiny ViT-VQGAN, fp32): losses, and every parameter after
  two AdamW steps (Adam's bias correction, decayed and undecayed leaves).
- The decay mask leaf by leaf against ``gpt_decay_mask``.
- ``Trainer.fit`` on a ``CondTransformer``: losses, moved parameters,
  fp32 master weights with the q/k/v tie intact, sampling afterwards.
- The attention backward's routes at head dim 384.

JAX weights are drawn from a seed and carried across with
``compat.load_gpt_from_jax`` / ``load_vitvq_from_jax``; inputs are made
with numpy from a seed. Each tolerance is stated where it is used.
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
from enhancing_tpu.models.stage2.transformer import \
    CondTransformer as JaxCondTransformer
from enhancing_tpu.ops import attention as jatt
from enhancing_tpu.train.optim import gpt_decay_mask as jax_decay_mask
from enhancing_tpu.train.optim import make_gpt_optimizer as jax_gpt_optimizer
from enhancing_tpu.train.steps import TrainState as JaxTrainState
from enhancing_tpu.train.steps import (
    make_cond_transformer_eval_step as jax_eval_step)
from enhancing_tpu.train.steps import (
    make_cond_transformer_train_step as jax_train_step)
from enhancing_tpu_torch.compat import load_gpt_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.compat.from_jax import _gpt_name
from enhancing_tpu_torch.models.stage2 import (CondTransformer,
                                               fp32_master_weights)
from enhancing_tpu_torch.ops import attention as tatt
from enhancing_tpu_torch.train import (Trainer, TrainState, gpt_decay_mask,
                                       make_cond_transformer_eval_step,
                                       make_cond_transformer_train_step,
                                       make_gpt_optimizer)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config, remap_targets)

REPO = Path(__file__).resolve().parents[1]

# tests/test_train.py::test_cond_transformer_training's prior
VIT = dict(dim=64, depth=2, heads=2, mlp_dim=128)
PRIOR = dict(
    cond_key="class",
    cond={"target": "enhancing_tpu.models.cond.dummycond.ClassCond",
          "params": {"image_size": 32, "class_name": ["a", "b", "c"]}},
    stage1={"target": "enhancing_tpu.models.stage1.vitvqgan.ViTVQ",
            "params": {"image_size": 32, "patch_size": 8, "encoder": VIT,
                       "decoder": VIT,
                       "quantizer": dict(embed_dim=16, n_embed=64)}},
    transformer={"target": "enhancing_tpu.models.stage2.layers.GPT",
                 "params": {"vocab_cond_size": 1000, "vocab_img_size": 64,
                            "embed_dim": 32, "cond_num_tokens": 1,
                            "img_num_tokens": 16, "n_heads": 2,
                            "n_layers": 2}})
FAKE_DATA = {
    "target": "enhancing_tpu_torch.data.DataModuleFromConfig",
    "params": {
        "batch_size": 4, "num_workers": 0,
        "train": {"target": "enhancing_tpu_torch.data.fake.FakeImages",
                  "params": {"length": 16, "resolution": 32,
                             "num_classes": 3}},
        "validation": {"target": "enhancing_tpu_torch.data.fake.FakeImages",
                       "params": {"length": 4, "resolution": 32,
                                  "num_classes": 3, "seed": 7}}}}
# fp32 through two blocks and a vocab head, another summation order on
# each side; an Adam step moves a parameter by about lr
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the differentiable (B, N, H, D) entry -----------------------------------

# head dim -> tokens: 17 (the kernels' route on CUDA), but 4 at the RQ
# prior's depth head dim 192, its depth window, where the short route's
# plain version is differentiated on CUDA too; 96 is the RQ prior's
# spatial head dim (B5 on the 128 tile)
BNHD_TOKENS = {384: 17, 64: 17, 32: 17, 96: 17, 192: 4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,cl", [("none", 0), ("prefix_causal", 1)])
@pytest.mark.parametrize("d", [384, 64, 32, 96, 192])
def test_bnhd_gradients_match_jax_vjp(d, mode, cl, dtype):
    """dq, dk, dv of multihead_attention_bnhd against jax.vjp of the JAX
    function (2 heads, N = M = BNHD_TOKENS[d]). fp32 to 1e-5; bf16 to 2^-6
    of the largest |JAX| + 2^-6 relative, the port's bf16
    attention-gradient tolerance (one bf16 step on N-term sums, rounded at
    other places)."""
    b, n, h = 2, BNHD_TOKENS[d], 2
    rng = np.random.default_rng(d + len(mode))
    q, k, v, do = (rng.standard_normal((b, n, h, d)).astype(np.float32)
                   for _ in range(4))
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.multihead_attention_bnhd(
        q_, k_, v_, mask_mode=mode, cond_len=cl),
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jd))
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    out = tatt.multihead_attention_bnhd(*leaves, mask_mode=mode, cond_len=cl)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(td))
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32)
        tol = (F32_TOL if dtype == "float32" else
               dict(atol=2.0 ** -6 * float(np.abs(w).max()), rtol=2.0 ** -6))
        np.testing.assert_allclose(g.float().numpy(), w, **tol,
                                   err_msg="d" + name)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, ("attn_bwd_wide", 384)),
    (torch.float32, ("attn_f32_bwd_wide", 384))])
def test_backward_route_at_384(dtype, want):
    """The prior's head dim runs the backward of csrc/attention_bwd_wide.cu
    in both dtypes; its forward keeps its kernels."""
    assert tatt.attention_route(dtype, 384, backward=True) == want
    assert tatt.attention_route(dtype, 384)[0] in ("attn_wide_kernel",
                                                   "attn_f32_wide_kernel")


# -- the prior's train and eval steps ----------------------------------------

@pytest.fixture(scope="module")
def priors():
    """The JAX tiny prior (seed 0) and the port's, weights carried across;
    a fixed batch of images and condition codes."""
    jm = JaxCondTransformer(**PRIOR)
    tm = CondTransformer(**remap_targets(PRIOR), device="cpu")
    load_gpt_from_jax(tm, _np(jm.params))
    load_vitvq_from_jax(tm.stage1_model, _np(jm.stage1_model.params))
    rng = np.random.default_rng(3)
    images = rng.random((4, 32, 32, 3), dtype=np.float32)
    conds = np.array([[0], [2], [1], [2]], np.int32)
    return jm, tm, images, conds


def test_two_prior_steps_match_jax(priors):
    """Two train steps from the same weights and batch: the losses, and
    every prior parameter afterwards (JAX's carried into a port model and
    compared by name), F32_TOL; then the eval step's val/total_loss."""
    jm, tm, images, conds = priors
    tx = jax_gpt_optimizer(LR)
    params = jax.tree_util.tree_map(jnp.array, jm.params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt=tx.init(params))
    step = jax_train_step(jm, tx)
    want_losses = []
    for _ in range(2):
        state, log = step(state, jnp.asarray(images), jnp.asarray(conds))
        want_losses.append(float(log["train/total_loss"]))
    want_val = float(jax_eval_step(jm)(state, jnp.asarray(images),
                                       jnp.asarray(conds))["val/total_loss"])

    gpt = fp32_master_weights(tm.transformer)
    tstate = TrainState(step=0, opt=make_gpt_optimizer(gpt, LR))
    tstep = make_cond_transformer_train_step(tm)
    x, c = torch.from_numpy(images), torch.from_numpy(conds)
    got_losses = [float(tstep(tstate, x, c)["train/total_loss"])
                  for _ in range(2)]
    np.testing.assert_allclose(got_losses, want_losses, **F32_TOL)
    assert tstate.step == 2

    ref = CondTransformer(**remap_targets(PRIOR), device="cpu").transformer
    load_gpt_from_jax(ref, _np(state.params))
    want_params = dict(ref.named_parameters())
    for name, p in gpt.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].detach().numpy(),
                                   **F32_TOL, err_msg=name)
    got_val = make_cond_transformer_eval_step(tm)(tstate, x, c)
    np.testing.assert_allclose(float(got_val["val/total_loss"]), want_val,
                               **F32_TOL)


def test_decay_mask_matches_jax_leaf_by_leaf(priors):
    """The port's mask, decided on each parameter's JAX path, equals
    gpt_decay_mask on the JAX tree (scan_layers=False) leaf by leaf; the
    JAX pattern read on the port's own names would decay the token
    embeddings and spare no GEMM."""
    _, tm, _, _ = priors
    widths = PRIOR["transformer"]["params"]
    jgpt = JaxGPT(**widths, scan_layers=False)
    tokens = (jnp.zeros((1, widths["img_num_tokens"]), jnp.int32),
              jnp.zeros((1, widths["cond_num_tokens"]), jnp.int32))
    want = jax_decay_mask(jgpt.init(jax.random.PRNGKey(0), *tokens)["params"])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = gpt_decay_mask(tm.transformer)
    assert len(flat) == len(got)
    for path, decay in flat:
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        assert got[_gpt_name(keys)[0]] == decay, keys
    assert not got["tok_emb_code.weight"] and not got["blocks_0.ln1.weight"]
    assert got["blocks_0.attn.query.weight"] and got["head.weight"]


# -- Trainer.fit on a CondTransformer ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_fits_the_prior(dtype):
    """Three steps of Trainer.fit, then validation: finite losses, every
    prior parameter moved, the GEMM weights fp32 masters whose q/k/v blocks
    are still views of the fused qkv tensor the decode path reads; then
    sample() still returns pixels in [0, 1], as the JAX test asserts."""
    cfg = remap_targets(PRIOR)
    cfg["transformer"]["params"]["dtype"] = dtype
    model = CondTransformer(**cfg, device="cpu")
    gpt = model.transformer
    before = {n: p.detach().float().clone()
              for n, p in gpt.named_parameters()}
    seen = []

    class Recorder:
        def log_metrics(self, metrics, step):
            seen.append((step, metrics))

    trainer = Trainer(max_steps=3, base_lr=LR, log_every=1,
                      metrics_logger=Recorder())
    trainer.fit(model, initialize_from_config(FAKE_DATA))
    assert trainer.final_state.step == 3
    assert [s for s, _ in seen] == [1, 2, 3, 3]
    assert "val/total_loss" in seen[-1][1]
    for _, metrics in seen:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    moved = [n for n, p in gpt.named_parameters()
             if not torch.equal(p.float(), before[n])]
    assert len(moved) == len(before)
    for block in gpt.blocks:
        attn = block.attn
        assert attn.query.weight.dtype == torch.float32
        assert attn.query.weight.requires_grad
        for attr in ("weight", "bias"):
            fused = attn.qkv_tied[attr]
            parts = [getattr(d, attr) for d in (attn.query, attn.key,
                                                attn.value)]
            step = parts[0].numel() * parts[0].element_size()
            assert all(p.data_ptr() == fused.data_ptr() + i * step
                       for i, p in enumerate(parts)), attr
            assert attn.fused_qkv(attr) is fused
            assert torch.equal(fused, torch.cat([p.detach() for p in parts]))
    pixels = model.sample(np.array([[0], [1]]), top_k=8)
    assert pixels.shape == (2, 32, 32, 3)
    assert float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0


def test_chip_smoke_trains_the_shipped_prior_config():
    """chip_smoke.py's prior-training phase builds
    configs/imagenet_gpt_vitvq_base.yaml's model with only the prior's
    depth and dtype changed (and no stage-1 checkpoint path), at the
    config's batch size, on FakeImages of its resolution and classes."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shipped = load_config(REPO / "configs" /
                          "imagenet_gpt_vitvq_base.yaml").to_dict()
    shipped["model"]["params"]["stage1"]["params"].pop("path")
    for dtype, layers, _ in smoke.PRIOR_RUNS:
        cfg = smoke.prior_train_config(dtype, layers)
        want = copy.deepcopy(shipped["model"])
        want["params"]["transformer"]["params"].update(n_layers=layers,
                                                       dtype=dtype)
        assert cfg["model"] == want
        data = cfg["dataset"]["params"]
        assert data["batch_size"] == shipped["dataset"]["params"][
            "batch_size"] == smoke.PRIOR_TRAIN_BATCH
        for split in ("train", "validation"):
            assert data[split]["params"]["resolution"] == 256
            assert data[split]["params"]["num_classes"] == 1000
