"""The port's stage-1 train step and Trainer against the JAX package's,
on the CPU.

``configs/fake_vitvq_tiny.yaml`` builds both sides (32 px, two-layer ViTs,
the StyleGAN discriminator at 32 px, random LPIPS); the JAX parameters of
the autoencoder, the discriminator and LPIPS are carried into the port.
One train step on the same batch then gives every log value and, after
the AdamW updates, the parameters of both sides. All in f32.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.train.optim import make_ae_optimizer as jax_make_optimizer
from enhancing_tpu.train.steps import GANTrainState as JaxGANTrainState
from enhancing_tpu.train.steps import \
    make_vitvq_train_step as jax_make_train_step
from enhancing_tpu.utils.config import \
    initialize_from_config as jax_initialize_from_config
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import (load_lpips_from_jax,
                                        load_style_discriminator_from_jax,
                                        load_vitvq_from_jax)
from enhancing_tpu_torch.train import (GANTrainState, Trainer,
                                       make_ae_optimizer,
                                       make_vitvq_train_step)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "fake_vitvq_tiny.yaml"
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    jm = jax_initialize_from_config(jax_load_config(TINY).model)
    return jm, {"ae": _np_tree(jm.params),
                "disc": _np_tree(jm.loss.disc_init_params),
                "lpips": _np_tree(jm.loss.lpips_params)}


def _port_model(trees):
    model = initialize_from_config(load_config(TINY).model, device="cpu")
    load_vitvq_from_jax(model, trees["ae"])
    load_style_discriminator_from_jax(model.loss.discriminator,
                                      trees["disc"])
    load_lpips_from_jax(model.loss.perceptual, trees["lpips"])
    return model


def _batch():
    low = np.random.default_rng(0).random((4, 4, 4, 3), dtype=np.float32)
    return np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "r1"])
def one_step(request, jax_side):
    """(JAX log, JAX new state, port log, port model, initial port model)
    after one step from identical weights, without or with R1."""
    do_r1 = request.param
    jm, trees = jax_side
    x = _batch()
    ae_tx, disc_tx = jax_make_optimizer(LR), jax_make_optimizer(LR)
    ae, disc = (jax.tree_util.tree_map(jnp.asarray, trees[k])
                for k in ("ae", "disc"))
    state = JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), ae_params=ae, ae_opt=ae_tx.init(ae),
        disc_params=disc, disc_opt=disc_tx.init(disc),
        lpips_params=jax.tree_util.tree_map(jnp.asarray, trees["lpips"]))
    step = jax_make_train_step(jm, jm.loss, ae_tx, disc_tx)
    new_state, jlog = step(state, jnp.asarray(x), jax.random.PRNGKey(0),
                           jnp.float32(1.0), do_r1=do_r1)

    model = _port_model(trees)
    before = copy.deepcopy(model)
    tstate = GANTrainState(
        0, make_ae_optimizer(model.module.parameters(), LR),
        make_ae_optimizer(model.loss.discriminator.parameters(), LR))
    tlog = make_vitvq_train_step(model, model.loss)(
        tstate, torch.from_numpy(x), do_r1=do_r1)
    assert tstate.step == 1
    return jlog, new_state, tlog, model, before


def test_train_step_logs_match_jax(one_step):
    jlog, _, tlog, _, _ = one_step
    assert set(tlog) == set(jlog)
    for k in jlog:
        # f32 losses through the ViT, LPIPS and the discriminator (R1: a
        # second-order backward), another summation order on each side
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def _updates(after, before, jax_new, load):
    """Per-tensor (port update, JAX update) / lr, in the port's layout."""
    ref = copy.deepcopy(before)
    load(ref, _np_tree(jax_new))
    b = dict(before.named_parameters())
    r = dict(ref.named_parameters())
    for name, p in after.named_parameters():
        yield (name, ((p - b[name]) / LR).detach().numpy(),
               ((r[name] - b[name]) / LR).detach().numpy())


@pytest.mark.parametrize("side", ["ae", "disc"])
def test_train_step_parameters_match_jax(one_step, side):
    """AdamW's first step moves each entry by lr * (g / (|g| + eps) + wd *
    p), so the updates are compared in units of lr: to 1e-2 of lr, except
    entries whose gradient is below 1e-6 of its tensor's largest, where
    the f32 noise of the two sides sets g / (|g| + eps) (at most 1e-4 of
    the entries, and within 2 lr)."""
    _, new_state, _, model, before = one_step
    if side == "ae":
        triples = _updates(model.module, before.module, new_state.ae_params,
                           load_vitvq_from_jax)
    else:
        triples = _updates(model.loss.discriminator,
                           before.loss.discriminator, new_state.disc_params,
                           load_style_discriminator_from_jax)
    moved = 0
    for name, got, want in triples:
        off = np.abs(got - want) > 1e-2
        assert off.mean() <= 1e-4, (name, off.sum(), got.size)
        assert np.all(np.abs(got - want) <= 2.0 + 1e-3), name
        moved += int((np.abs(got) > 0.5).sum())
    assert moved > 0


def test_trainer_fits_the_tiny_config():
    cfg = load_config(TINY)
    cfg.dataset.params.batch_size = 4
    cfg.dataset.params.validation.params.length = 8
    model = initialize_from_config(cfg.model, device="cpu")
    data = initialize_from_config(cfg.dataset)
    before = {n: p.detach().clone()
              for n, p in model.module.named_parameters()}
    seen = []

    class Recorder:
        def log_metrics(self, metrics, step):
            seen.append((step, metrics))

    trainer = Trainer(max_steps=2, base_lr=1e-4, log_every=1,
                      metrics_logger=Recorder())
    trainer.fit(model, data)
    assert trainer.final_state.step == 2
    assert [s for s, _ in seen] == [1, 2, 2]  # two steps, then validation
    assert "train/r1_reg" in seen[0][1] and "train/r1_reg" not in seen[1][1]
    assert "val/disc_loss" in seen[2][1]
    for _, metrics in seen:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    moved = [n for n, p in model.module.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) == len(before)
    assert not model.module.training


@pytest.mark.parametrize("option", ["random_lpips", "basedir", "resume",
                                    "zero1"])
def test_trainer_refuses_random_lpips_and_unsupported_options(option,
                                                              tmp_path):
    """Training against a random LPIPS without ``allow_random_lpips``, and
    the options the port cannot honour yet (a sharded optimizer, ROADMAP
    A9), each raise; checkpoints (``basedir``, ``resume``) are taken now
    (``tests/test_torch_resume.py`` holds them)."""
    if option == "random_lpips":
        cfg = load_config(TINY)
        cfg.model.params.loss.params.allow_random_lpips = False
        model = initialize_from_config(cfg.model, device="cpu")
        with pytest.raises(ValueError, match="allow_random_lpips"):
            Trainer(max_steps=1).fit(model,
                                     initialize_from_config(cfg.dataset))
        return
    if option in ("basedir", "resume"):
        trainer = Trainer(basedir=str(tmp_path), resume=option == "resume")
        assert trainer.ckpt.root == tmp_path / "ckpt"
        assert trainer.ckpt.latest_step() is None
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Trainer(zero1=True)


def test_chip_smoke_holds_the_base_training_config():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = load_config(REPO / "configs" / "fake_vitvq_base.yaml").to_dict()
    assert smoke.FAKE_VITVQ_BASE == want
