"""Training the stage-2 RQ prior with the port, against the JAX package, on
the CPU.

- ``fp32_master_weights`` finds a prior's blocks before it touches a
  weight: an RQ prior in bf16 leaves it with fp32 GEMM weights whose q/k/v
  blocks are views of the fused qkv tensor; any other module raises and
  keeps its weights.
- The prior's train and eval steps on ``configs/fake_rq_tiny.yaml`` (an
  RQTransformer over a tiny RQ-VAE's (B, T, 2) residual codes) against
  JAX's ``make_cond_transformer_train_step`` /
  ``make_cond_transformer_eval_step``: losses, and every parameter after
  two AdamW steps; the eval loss on (B * T, D) targets.
- The token shift's gradients: time_mix's summed in fp32, the others as
  autograd gives them, against an fp64 sum and ``jax.vjp``.
- The decay mask leaf by leaf against JAX's ``gpt_decay_mask`` on the RQ
  prior's names (``spatial_{i}``, ``depth_{i}``, ``pos_emb_depth``,
  ``ln_spatial``, ``ln_depth``, ``head``).
- ``Trainer.fit`` on the config's model: losses, moved parameters, fp32
  master weights with the q/k/v tie intact, sampling afterwards.
- ``chip_smoke.py``'s RQ-training phase builds the shipped config.

JAX weights are drawn from a seed and carried across with
``compat.load_rq_from_jax`` / ``load_vitvq_from_jax``; inputs are made with
numpy from a seed. fp32 unless a test says otherwise; each tolerance
stated.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.models.stage2 import RQTransformer as JaxRQ
from enhancing_tpu.train.optim import gpt_decay_mask as jax_decay_mask
from enhancing_tpu.train.optim import make_gpt_optimizer as jax_gpt_optimizer
from enhancing_tpu.train.steps import TrainState as JaxTrainState
from enhancing_tpu.train.steps import (
    make_cond_transformer_eval_step as jax_eval_step)
from enhancing_tpu.train.steps import (
    make_cond_transformer_train_step as jax_train_step)
from enhancing_tpu.utils.config import initialize_from_config as jax_init
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import load_rq_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.compat.from_jax import _gpt_name
from enhancing_tpu_torch.models.stage1.layers import Dense
from enhancing_tpu_torch.models.stage2 import (RQTransformer,
                                               fp32_master_weights)
from enhancing_tpu_torch.train import (Trainer, TrainState, gpt_decay_mask,
                                       make_cond_transformer_eval_step,
                                       make_cond_transformer_train_step,
                                       make_gpt_optimizer)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "fake_rq_tiny.yaml"
# configs/fake_rq_tiny.yaml's prior
TINY = dict(vocab_cond_size=1000, vocab_img_size=128, embed_dim=64,
            cond_num_tokens=1, img_num_tokens=16, depth_num_tokens=2,
            spatial_n_heads=2, depth_n_heads=2, spatial_n_layers=2,
            depth_n_layers=1)
FAKE_DATA = {
    "target": "enhancing_tpu_torch.data.DataModuleFromConfig",
    "params": {
        "batch_size": 4, "num_workers": 0,
        "train": {"target": "enhancing_tpu_torch.data.fake.FakeImages",
                  "params": {"length": 8, "resolution": 32,
                             "num_classes": 3}},
        "validation": {"target": "enhancing_tpu_torch.data.fake.FakeImages",
                       "params": {"length": 4, "resolution": 32,
                                  "num_classes": 3, "seed": 7}}}}
# fp32 through a few blocks and a vocab head, another summation order on
# each side; an Adam step moves a parameter by about lr
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tied(attn, attr) -> bool:
    """Whether the query, key and value parameters ``attr`` are the row
    blocks of the fused qkv tensor, in order."""
    fused = attn.qkv_tied[attr]
    parts = [getattr(d, attr) for d in (attn.query, attn.key, attn.value)]
    step = parts[0].numel() * parts[0].element_size()
    return (all(p.data_ptr() == fused.data_ptr() + i * step
                for i, p in enumerate(parts))
            and attn.fused_qkv(attr) is fused)


# -- ROADMAP C2: fp32_master_weights on the RQ prior --------------------------

def test_fp32_master_weights_takes_the_rq_prior():
    """A bf16 RQ prior leaves with every GEMM weight and bias fp32 (their
    values the bf16 ones widened), each spatial and depth block's q/k/v
    parameters views of the fused qkv tensor, and the compute dtype
    unchanged."""
    rq = RQTransformer(**TINY, dtype="bfloat16", device="cpu")
    before = {n: p.detach().clone() for n, p in rq.named_parameters()}
    assert rq.spatial_0.attn.query.weight.dtype == torch.bfloat16
    assert fp32_master_weights(rq) is rq
    for name, p in rq.named_parameters():
        assert p.dtype == torch.float32, name
        assert torch.equal(p, before[name].float()), name
    blocks = rq.spatial_blocks + rq.depth_blocks
    assert len(blocks) == 3
    for block in blocks:
        for attr in ("weight", "bias"):
            assert _tied(block.attn, attr), attr
    assert rq.dtype == torch.bfloat16
    with torch.no_grad():  # an in-place update reaches the fused product
        rq.depth_0.attn.value.weight.add_(1.0)
    fused = rq.depth_0.attn.fused_qkv("weight")
    assert torch.equal(fused[2 * 64:], rq.depth_0.attn.value.weight)


def test_fp32_master_weights_refuses_an_unknown_prior():
    """A module that is neither GPT nor RQTransformer raises TypeError
    before any weight is cast: its bf16 parameters stay the same tensors."""
    module = torch.nn.Sequential(Dense(8, 8, dtype=torch.bfloat16,
                                       param_dtype=torch.bfloat16))
    weight = module[0].weight
    with pytest.raises(TypeError, match="GPT or an RQTransformer"):
        fp32_master_weights(module)
    assert module[0].weight is weight
    assert weight.dtype == torch.bfloat16


# -- the token shift's gradients ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_shift_gradients(dtype):
    """MultiHeadSelfAttention.token_shift under grad: the output and the
    gradients of x equal autograd's of x * tm + delay(x) * (1 - tm) in
    the compute dtype bit for bit; time_mix's gradient, summed in fp32
    from (x - delay(x)) * g, within 1e-5 of the norm of an fp64 sum of the
    same bf16 or fp32 operands, where autograd of the bf16 expression rounds
    two nearly cancelling sums (x close to its delay here) to bf16; in
    fp32, the output and all gradients against jax.vjp of the JAX
    package's expression within F32_TOL."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((2, 1, 64)).astype(np.float32)
    x_np = (base + 0.05 * rng.standard_normal((2, 33, 64))).astype(np.float32)
    g_np = rng.standard_normal((2, 33, 64)).astype(np.float32)
    tm_np = np.linspace(0, 1, 64, dtype=np.float32).reshape(1, 1, 64)
    td = getattr(torch, dtype)
    attn = RQTransformer(**TINY, device="cpu").spatial_0.attn
    with torch.no_grad():
        attn.time_mix.copy_(torch.from_numpy(tm_np))
    x = torch.from_numpy(x_np).to(td).requires_grad_()
    g = torch.from_numpy(g_np).to(td)
    out = attn.token_shift(x)
    gx, gtm = torch.autograd.grad(out, (x, attn.time_mix), g)
    assert gtm.dtype == torch.float32
    xr = x.detach().clone().requires_grad_()
    tm = attn.time_mix.detach().to(td)
    shifted = torch.nn.functional.pad(xr, (0, 0, 1, 0))[:, :-1]
    want = xr * tm + shifted * (1.0 - tm)
    (want_gx,) = torch.autograd.grad(want, (xr,), g)
    assert torch.equal(out, want) and torch.equal(gx, want_gx)
    x64 = x.detach().double()
    s64 = torch.nn.functional.pad(x64, (0, 0, 1, 0))[:, :-1]
    exact = ((x64 - s64) * g.double()).sum(dim=(0, 1), keepdim=True)
    err = float((gtm.double() - exact).norm() / exact.norm())
    assert err <= 1e-5, err
    if dtype == "float32":
        def shift(x_, tm_):
            s_ = jnp.pad(x_, ((0, 0), (1, 0), (0, 0)))[:, :-1]
            return x_ * tm_ + s_ * (1.0 - tm_)
        j_out, vjp = jax.vjp(shift, jnp.asarray(x_np), jnp.asarray(tm_np))
        j_gx, j_gtm = vjp(jnp.asarray(g_np))
        for got, ref in ((out, j_out), (gx, j_gx), (gtm, j_gtm)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                       **F32_TOL)


# -- the prior's train and eval steps ----------------------------------------

@pytest.fixture(scope="module")
def priors():
    """configs/fake_rq_tiny.yaml's model on both sides (JAX's weights from
    its constructor's seed 0, carried into the port's), and a fixed batch
    of images and condition codes."""
    jm = jax_init(jax_load_config(CONFIG).model)
    tm = initialize_from_config(load_config(CONFIG).model, device="cpu")
    assert jm.is_rq and tm.is_rq
    load_rq_from_jax(tm, _np(jm.params))
    load_vitvq_from_jax(tm.stage1_model, _np(jm.stage1_model.params))
    rng = np.random.default_rng(4)
    images = rng.random((4, 32, 32, 3), dtype=np.float32)
    conds = np.array([[0], [998], [17], [2]], np.int32)
    return jm, tm, images, conds


def test_two_rq_prior_steps_match_jax(priors):
    """Two train steps from the same weights and batch: the frozen RQ-VAE's
    (B, T, 2) codes equal, the losses and every prior parameter afterwards
    (JAX's carried into a port model and compared by name) within F32_TOL;
    then the eval step's val/total_loss on (B * T, D) targets."""
    jm, tm, images, conds = priors
    want_codes = np.asarray(jm.stage1_model.encode_codes(jnp.asarray(images)))
    with torch.no_grad():
        got_codes = tm.stage1_model.module.encode_codes(
            torch.from_numpy(images))
    assert got_codes.shape == (4, 16, 2)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)

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

    rq = fp32_master_weights(tm.transformer)
    tstate = TrainState(step=0, opt=make_gpt_optimizer(rq, LR))
    tstep = make_cond_transformer_train_step(tm)
    x, c = torch.from_numpy(images), torch.from_numpy(conds)
    got_losses = [float(tstep(tstate, x, c)["train/total_loss"])
                  for _ in range(2)]
    np.testing.assert_allclose(got_losses, want_losses, **F32_TOL)
    assert tstate.step == 2

    ref = RQTransformer(**TINY, device="cpu")
    load_rq_from_jax(ref, _np(state.params))
    want_params = dict(ref.named_parameters())
    for name, p in rq.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].detach().numpy(),
                                   **F32_TOL, err_msg=name)
    got_val = make_cond_transformer_eval_step(tm)(tstate, x, c)
    np.testing.assert_allclose(float(got_val["val/total_loss"]), want_val,
                               **F32_TOL)


def test_rq_decay_mask_matches_jax_leaf_by_leaf(priors):
    """The port's mask, decided on each parameter's JAX path, equals
    gpt_decay_mask on the JAX RQ tree (scan_layers=False) leaf by leaf."""
    _, tm, _, _ = priors
    jrq = JaxRQ(**TINY, scan_layers=False)
    tokens = (jnp.zeros((1, TINY["img_num_tokens"],
                         TINY["depth_num_tokens"]), jnp.int32),
              jnp.zeros((1, TINY["cond_num_tokens"]), jnp.int32))
    want = jax_decay_mask(jrq.init(jax.random.PRNGKey(0), *tokens)["params"])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = gpt_decay_mask(tm.transformer)
    assert len(flat) == len(got)
    for path, decay in flat:
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        assert got[_gpt_name(keys)[0]] == decay, keys
    for name in ("pos_emb_depth", "ln_spatial.weight", "ln_depth.bias",
                 "depth_0.ln1.weight", "spatial_1.attn.time_mix",
                 "tok_emb_code.weight"):
        assert not got[name], name
    for name in ("spatial_0.attn.query.weight", "depth_0.mlp.p1.weight",
                 "head.weight"):
        assert got[name], name


# -- Trainer.fit on the RQ prior ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_fits_the_rq_prior(dtype):
    """Two steps of Trainer.fit on configs/fake_rq_tiny.yaml's model, then
    validation: finite losses, every prior parameter moved, the GEMM
    weights fp32 masters whose q/k/v blocks are still views of the fused
    qkv tensor; then sample() still returns (B, 16, 2) codes and pixels in
    [0, 1]."""
    cfg = load_config(CONFIG).model.to_dict()
    cfg["params"]["transformer"]["params"]["dtype"] = dtype
    model = initialize_from_config(cfg, device="cpu")
    rq = model.transformer
    before = {n: p.detach().float().clone()
              for n, p in rq.named_parameters()}
    seen = []

    class Recorder:
        def log_metrics(self, metrics, step):
            seen.append((step, metrics))

    trainer = Trainer(max_steps=2, base_lr=LR, log_every=1,
                      metrics_logger=Recorder())
    trainer.fit(model, initialize_from_config(FAKE_DATA))
    assert trainer.final_state.step == 2
    assert [s for s, _ in seen] == [1, 2, 2]
    assert "val/total_loss" in seen[-1][1]
    for _, metrics in seen:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    moved = [n for n, p in rq.named_parameters()
             if not torch.equal(p.float(), before[n])]
    assert len(moved) == len(before)
    for block in rq.spatial_blocks + rq.depth_blocks:
        assert block.attn.query.weight.dtype == torch.float32
        assert block.attn.query.weight.requires_grad
        for attr in ("weight", "bias"):
            assert _tied(block.attn, attr), attr
    pixels, codes = model.sample(np.array([[0], [1]]), top_k=8,
                                 return_codes=True)
    assert codes.shape == (2, 16, 2) and pixels.shape == (2, 32, 32, 3)
    assert float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0


def test_chip_smoke_trains_the_shipped_rq_config():
    """chip_smoke.py's RQ-training phase builds
    configs/imagenet_rqtransformer_base.yaml's model with only the prior's
    dtype changed (and no stage-1 checkpoint path), at full depth and the
    config's batch size, on FakeImages of its resolution and 1000 classes;
    its int8 phase's cache context is the one RQTransformer's kv_int8
    cache pads the config's 1 + 1024 tokens to."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shipped = load_config(REPO / "configs" /
                          "imagenet_rqtransformer_base.yaml").to_dict()
    shipped["model"]["params"]["stage1"]["params"].pop("path")
    assert [d for d, _ in smoke.RQ_TRAIN_RUNS] == ["bfloat16", "float32"]
    for dtype, _ in smoke.RQ_TRAIN_RUNS:
        cfg = smoke.rq_train_config(dtype)
        want = copy.deepcopy(shipped["model"])
        want["params"]["transformer"]["params"]["dtype"] = dtype
        assert cfg["model"] == want
        data = cfg["dataset"]["params"]
        assert data["batch_size"] == shipped["dataset"]["params"][
            "batch_size"] == smoke.RQ_TRAIN_BATCH
        for split in ("train", "validation"):
            assert data[split]["params"]["resolution"] == 256
            assert data[split]["params"]["num_classes"] == 1000
    prior = shipped["model"]["params"]["transformer"]["params"]
    small = dict(prior, embed_dim=16, spatial_n_heads=2, depth_n_heads=2,
                 spatial_n_layers=1, depth_n_layers=1, vocab_img_size=16,
                 vocab_cond_size=4, kv_int8=True)
    cache = RQTransformer(**small, device="cpu").init_cache(1)
    assert cache["k"].shape[2] == smoke.RQ_INT8_CTX == 1152
