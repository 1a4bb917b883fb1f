"""Gradient accumulation of the stage-2 prior's training against the JAX
package's ``optax.MultiSteps``, on the CPU.

The tiny class-conditional GPT of ``configs/fake_gpt_tiny.yaml`` over its
tiny tokenizer, f32, JAX weights carried into the port with
``compat.load_gpt_from_jax`` / ``load_vitvq_from_jax``; batches made with
numpy from a seed. Torch runs on one thread here: the tests share the
CPU with other test processes.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhancing_tpu.train.optim import make_gpt_optimizer as jax_gpt_optimizer
from enhancing_tpu.train.steps import TrainState as JaxTrainState
from enhancing_tpu.train.steps import \
    make_cond_transformer_train_step as jax_train_step
from enhancing_tpu.utils.config import \
    initialize_from_config as jax_initialize_from_config
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import load_gpt_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.models.stage2 import fp32_master_weights
from enhancing_tpu_torch.train import (Trainer, TrainState,
                                       make_cond_transformer_train_step,
                                       make_gpt_optimizer)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
GPT_TINY = REPO / "configs" / "fake_gpt_tiny.yaml"
LR = 1e-3
# tests/test_torch_prior_train.py's limit: fp32 through two blocks and a
# vocab head, another summation order on each side; an Adam step moves a
# parameter by about lr
F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_accumulated_prior_steps_match_jax_multisteps():
    """accumulate=2: four micro-steps on four batches against JAX's step
    over optax.MultiSteps(every_k=2): each micro-step's loss, the prior's
    parameters bit-equal after micro-steps 1 and 3 and moved after 2 and
    4, and every parameter after the fourth against JAX's; the LR
    schedule stepped twice. A key bias's gradient is zero in exact
    arithmetic (the softmax removes a shift of a whole score row; ROADMAP
    C), so Adam moves it on each side by rounding residue: it is held
    within 1e-2 lr of where it started instead."""
    cfg = jax_load_config(GPT_TINY).model
    jm = jax_initialize_from_config(cfg)
    tm = initialize_from_config(load_config(GPT_TINY).model, device="cpu")
    load_gpt_from_jax(tm, _np(jm.params))
    load_vitvq_from_jax(tm.stage1_model, _np(jm.stage1_model.params))
    rng = np.random.default_rng(9)
    batches = [(rng.random((4, 32, 32, 3), dtype=np.float32),
                rng.integers(0, 1000, (4, 1)).astype(np.int32))
               for _ in range(4)]

    tx = jax_gpt_optimizer(LR, accumulate=2)
    params = jax.tree_util.tree_map(jnp.array, jm.params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt=tx.init(params))
    step = jax_train_step(jm, tx)
    want_losses = []
    for images, conds in batches:
        state, log = step(state, jnp.asarray(images), jnp.asarray(conds))
        want_losses.append(float(log["train/total_loss"]))

    gpt = fp32_master_weights(tm.transformer)
    tstate = TrainState(step=0, opt=make_gpt_optimizer(gpt, LR, accumulate=2))
    assert tstate.opt.every_k == 2
    tstep = make_cond_transformer_train_step(tm)
    last = [p.detach().clone() for p in gpt.parameters()]
    got_losses = []
    for i, (images, conds) in enumerate(batches):
        log = tstep(tstate, torch.from_numpy(images), torch.from_numpy(conds))
        got_losses.append(float(log["train/total_loss"]))
        now = [p.detach().clone() for p in gpt.parameters()]
        assert all(torch.equal(a, b) for a, b in zip(last, now)) == \
            (i % 2 == 0), i
        last = now
    np.testing.assert_allclose(got_losses, want_losses, **F32_TOL)
    assert tstate.step == 4 and tstate.opt.sched.last_epoch == 2

    ref = initialize_from_config(load_config(GPT_TINY).model,
                                 device="cpu").transformer
    load_gpt_from_jax(ref, _np(jm.params))
    start = {n: p.detach().clone() for n, p in ref.named_parameters()}
    load_gpt_from_jax(ref, _np(state.params))
    want = dict(ref.named_parameters())
    for name, p in gpt.named_parameters():
        if name.endswith("attn.key.bias"):
            for side in (p, want[name]):
                assert float((side - start[name]).abs().max()) <= 1e-2 * LR
            continue
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), **F32_TOL,
                                   err_msg=name)


def test_trainer_accumulates_prior_gradients():
    """Trainer(accumulate_grad_batches=2) on the tiny prior: the optimizer
    accumulates over 2 calls, four batches make two updates, every parameter
    moves."""
    cfg = load_config(GPT_TINY)
    cfg.dataset.params.batch_size = 4
    cfg.dataset.params.train.params.length = 16
    cfg.dataset.params.validation.params.length = 4
    model = initialize_from_config(cfg.model, device="cpu")
    before = [p.detach().clone() for p in model.transformer.parameters()]
    trainer = Trainer(max_steps=4, base_lr=LR, log_every=10,
                      accumulate_grad_batches=2)
    trainer.fit(model, initialize_from_config(cfg.dataset))
    state = trainer.final_state
    assert state.opt.every_k == 2
    assert state.step == 4 and state.opt.sched.last_epoch == 2
    assert all(not torch.equal(p, q) for p, q in
               zip(model.transformer.parameters(), before))
