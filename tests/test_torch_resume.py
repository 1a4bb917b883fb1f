"""Checkpoints and resume in the port's Trainer, against the JAX Trainer's,
on the CPU.

- The JAX Trainer fits one epoch with ``basedir``, then resumes to two
  (``tests/test_train.py``'s tiny tokenizer: 32 samples of batch 8, 4
  steps an epoch); the port does the same from the JAX weights carried in
  by ``compat``. ``global_step`` is 4, then 8 on both sides, a third
  resume is a no-op, and both resumed runs restart their per-step keys
  from ``seed`` (the JAX Trainer's ``PRNGKey(seed)`` at every fit). The
  final weights agree within the tolerance of ``tests/test_torch_train.py``
  scaled to 8 AdamW steps.
- Port only: an uninterrupted two-epoch run equals one epoch + resume bit
  for bit, for the VQ tokenizer with ``accumulate_grad_batches=2`` over 3
  steps an epoch (the save falls mid-accumulation) and for the GPT prior
  with its fp32 master weights; the restored state equals the saved one
  tensor by tensor.
- A resumed Gumbel run repeats the first epoch's keys, as the JAX one.
"""
import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import enhancing_tpu.train.trainer as jax_trainer_mod
import enhancing_tpu_torch.train.trainer as trainer_mod
from enhancing_tpu.models.stage1.vitvqgan import ViTVQ as JaxViTVQ
from enhancing_tpu.train import Trainer as JaxTrainer
from enhancing_tpu.utils.config import \
    initialize_from_config as jax_initialize_from_config
from enhancing_tpu_torch.compat import load_lpips_from_jax, load_vitvq_from_jax
from enhancing_tpu_torch.train import Trainer
from enhancing_tpu_torch.train.checkpoint import CheckpointDir
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)
from test_train import FAKE_DATA, Q, TINY

REPO = Path(__file__).resolve().parents[1]
LR = 3e-4
JAX_LOSS = {"target": "enhancing_tpu.losses.vqperceptual.VQLPIPS",
            "params": {"image_size": 32, "perceptual_weight": 0.0}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(tree):
    return {**tree, "target": tree["target"].replace(
        "enhancing_tpu.", "enhancing_tpu_torch.")} if isinstance(
            tree, dict) and "target" in tree else tree


def _port_config(value):
    if isinstance(value, dict):
        return _port({k: _port_config(v) for k, v in value.items()})
    return value


def _record_keys(module, keys, jax_side):
    """Wrap the module's ``make_vitvq_train_step`` so that each step's key
    is appended to ``keys``."""
    real = module.make_vitvq_train_step

    def make(*a, **kw):
        step = real(*a, **kw)
        if jax_side:
            def rec(state, x, rng, temp, do_r1=False):
                keys.append(tuple(np.asarray(jax.random.key_data(rng))
                                  if jax.dtypes.issubdtype(
                                      rng.dtype, jax.dtypes.prng_key)
                                  else np.asarray(rng)))
                return step(state, x, rng, temp, do_r1=do_r1)
        else:
            def rec(state, x, do_r1=False, rng=None, temp=None):
                keys.append(rng)
                return step(state, x, do_r1=do_r1, rng=rng, temp=temp)
        return rec
    return make


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX Trainer: one epoch with basedir, then resume to two. Returns
    (initial params, final params, global steps, per-step keys)."""
    base = tmp_path_factory.mktemp("jax_ckpt")
    keys = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_trainer_mod, "make_vitvq_train_step",
               _record_keys(jax_trainer_mod, keys, jax_side=True))
    try:
        m1 = JaxViTVQ(image_size=32, patch_size=8, encoder=TINY,
                      decoder=TINY, quantizer=Q, loss=JAX_LOSS)
        init = jax.tree_util.tree_map(np.asarray, m1.params)
        lpips = jax.tree_util.tree_map(np.asarray, m1.loss.lpips_params)
        t1 = JaxTrainer(max_epochs=1, base_lr=LR, basedir=str(base),
                        log_every=1000)
        t1.fit(m1, jax_initialize_from_config(FAKE_DATA))
        m2 = JaxViTVQ(image_size=32, patch_size=8, encoder=TINY,
                      decoder=TINY, quantizer=Q, loss=JAX_LOSS)
        t2 = JaxTrainer(max_epochs=2, base_lr=LR, basedir=str(base),
                        log_every=1000, resume=True)
        t2.fit(m2, jax_initialize_from_config(FAKE_DATA))
    finally:
        mp.undo()
    final = jax.tree_util.tree_map(np.asarray, m2.params)
    return init, lpips, final, (t1.global_step, t2.global_step), keys


def _port_model(init, lpips):
    model = initialize_from_config(_port_config({
        "target": "enhancing_tpu.models.stage1.vitvqgan.ViTVQ",
        "params": dict(image_size=32, patch_size=8, encoder=TINY,
                       decoder=TINY, quantizer=Q,
                       loss=_port_config(copy.deepcopy(JAX_LOSS)))}),
        device="cpu")
    load_vitvq_from_jax(model, init)
    load_lpips_from_jax(model.loss.perceptual, lpips)
    return model


def test_resume_matches_jax(jax_runs, tmp_path, monkeypatch):
    init, lpips, jax_final, jax_steps, jax_keys = jax_runs
    assert jax_steps == (4, 8)
    # the JAX resumed run restarts its keys from PRNGKey(seed)
    assert jax_keys[4:] == jax_keys[:4] and len(set(jax_keys[:4])) == 4

    keys = []
    monkeypatch.setattr(trainer_mod, "make_vitvq_train_step",
                        _record_keys(trainer_mod, keys, jax_side=False))
    data = _port_config(copy.deepcopy(FAKE_DATA))
    steps = []
    for epochs, resume in ((1, False), (2, True), (2, True)):
        model = _port_model(init, lpips)
        trainer = Trainer(max_epochs=epochs, base_lr=LR,
                          basedir=str(tmp_path), log_every=1000,
                          resume=resume)
        trainer.fit(model, initialize_from_config(data))
        steps.append(trainer.global_step)
        if len(steps) == 2:
            resumed = model
    assert steps == [4, 8, 8]   # the third resume is a no-op
    assert keys[4:] == keys[:4] and len(set(keys[:4])) == 4
    assert CheckpointDir(tmp_path / "ckpt").all_steps() == [0, 1]

    # per leaf, the total movement over 8 AdamW steps in units of lr:
    # test_torch_train.py's one-step bars (1e-2 of lr for all but 1e-4 of
    # the entries, 2 lr at most) times the 8 steps
    ref = _port_model(init, lpips)
    want_model = _port_model(jax_final, lpips)
    want = dict(want_model.module.named_parameters())
    before = dict(ref.module.named_parameters())
    moved = 0
    for name, p in resumed.module.named_parameters():
        got = ((p - before[name]) / LR).detach().numpy()
        exp = ((want[name] - before[name]) / LR).detach().numpy()
        off = np.abs(got - exp) > 8e-2
        assert off.mean() <= 8e-4, (name, off.sum(), got.size)
        assert np.all(np.abs(got - exp) <= 16.0 + 1e-3), name
        moved += int((np.abs(got) > 4.0).sum())
    assert moved > 0


def _tiny(cfg_name, train_length, **loss_params):
    cfg = load_config(REPO / "configs" / f"{cfg_name}.yaml")
    cfg.dataset.params.train.params.length = train_length
    cfg.dataset.params.validation.params.length = 8
    if loss_params:
        cfg.model.params.loss = {
            "target": "enhancing_tpu_torch.losses.vqperceptual.VQLPIPS",
            "params": loss_params}
    return cfg


def _trained(cfg, tmp, epochs, resume=False, accumulate=1):
    model = initialize_from_config(cfg.model, device="cpu")
    trainer = Trainer(max_epochs=epochs, base_lr=1e-3, log_every=1000,
                      basedir=tmp, resume=resume,
                      accumulate_grad_batches=accumulate)
    trainer.fit(model, initialize_from_config(cfg.dataset))
    return model, trainer


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_payloads_equal(got, want):
    got, want = dict(_tensors(got)), dict(_tensors(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k].cpu(), v.cpu()), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("which", ["vq_accumulate", "gpt"])
def test_resumed_run_is_bit_equal(which, tmp_path):
    if which == "gpt":
        cfg, acc, module = _tiny("fake_gpt_tiny", 24), 1, "transformer"
    else:
        cfg = _tiny("fake_vitvq_tiny", 24, image_size=32,
                    perceptual_weight=0.1, allow_random_lpips=True)
        acc, module = 2, "module"
    a, _ = _trained(cfg, None, 2, accumulate=acc)
    _, t1 = _trained(cfg, str(tmp_path), 1, accumulate=acc)
    saved = t1.restore(0)
    if which == "vq_accumulate":
        # 3 steps, 2 a update: the save falls between two updates
        assert saved["ae_opt"]["mini_step"] == 1
        assert saved["ae_opt"]["acc"] is not None
    else:
        # fp32 master weights of the prior
        assert all(v.dtype == torch.float32
                   for v in saved["params"].values())
    # the restored state equals the saved one tensor by tensor
    model = initialize_from_config(cfg.model, device="cpu")
    t = Trainer(base_lr=1e-3, basedir=str(tmp_path), resume=True,
                accumulate_grad_batches=acc)
    build = t._build_stage2 if which == "gpt" else t._build_stage1
    state = build(model)[0]
    assert t._maybe_resume(model, state) == 1 and t.global_step == 3
    _assert_payloads_equal(t._payload(model, state), saved)
    opt = state.opt if which == "gpt" else state.ae_opt
    assert opt.sched.last_epoch == saved[
        "opt" if which == "gpt" else "ae_opt"]["sched"]["last_epoch"]

    b, t2 = _trained(cfg, str(tmp_path), 2, resume=True, accumulate=acc)
    assert t2.global_step == 6
    want = getattr(a, module).state_dict()
    got = getattr(b, module).state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_gumbel_resume_repeats_the_first_keys(tmp_path, monkeypatch):
    """As the JAX Trainer, the port's re-seeds its running key at every
    fit: the resumed Gumbel run draws the first epoch's keys again."""
    keys = []

    def recorder(state, x, do_r1=False, rng=None, temp=None):
        keys.append((rng, temp))
        state.step += 1
        return {}

    monkeypatch.setattr(trainer_mod, "make_vitvq_train_step",
                        lambda *a, **kw: recorder)
    cfg = _tiny("fake_vitvq_tiny", 24)
    cfg.model.target = cfg.model.target.replace("ViTVQ", "ViTVQGumbel")
    del cfg.dataset.params["validation"]
    _trained(cfg, None, 2)
    uninterrupted = list(keys)
    keys.clear()
    _trained(cfg, str(tmp_path), 1)
    _, t = _trained(cfg, str(tmp_path), 2, resume=True)
    assert t.global_step == 6
    assert [k for k, _ in keys[3:]] == [k for k, _ in uninterrupted[:3]]
    assert [k for k, _ in uninterrupted[3:]] != \
        [k for k, _ in uninterrupted[:3]]
    # the temperature follows global_step across the resume
    assert [temp for _, temp in keys] == [temp for _, temp in uninterrupted]


def test_checkpoint_cadence_and_cut_off_saves(tmp_path):
    """Every ``checkpoint_every_epochs``-th epoch is saved and kept; a save
    cut off before its rename (a ``<epoch>.tmp`` directory) is never the
    newest checkpoint."""
    cfg = _tiny("fake_gpt_tiny", 16)
    model = initialize_from_config(cfg.model, device="cpu")
    trainer = Trainer(max_epochs=5, base_lr=1e-3, log_every=1000,
                      basedir=str(tmp_path), checkpoint_every_epochs=2)
    trainer.fit(model, initialize_from_config(cfg.dataset))
    ckpt = CheckpointDir(tmp_path / "ckpt")
    assert ckpt.all_steps() == [1, 3]
    assert [e for e, _, _ in trainer.saves] == [1, 3]
    (tmp_path / "ckpt" / "4.tmp").mkdir()
    torch.save({"cut": True}, tmp_path / "ckpt" / "4.tmp" / "state.pt")
    assert ckpt.latest_step() == 3
    assert trainer.restore()["step"] == 8
    with pytest.raises(ValueError, match="checkpoint_every_epochs"):
        Trainer(checkpoint_every_epochs=0)
