"""The training loop on one device.

Counterpart of ``enhancing_tpu/train/trainer.py:37-326``: ``fit(model,
data)`` runs the train step over the training loader for ``max_epochs``
epochs or ``max_steps`` steps, logs every ``log_every`` steps, and
validates at the end of each epoch. The model's ``device`` is the device
it trains on. A stage-1 tokenizer (``ViTVQ``) trains its GAN step, with
lazy R1 on every ``do_r1_every``-th batch of an epoch (batch 0 included);
a stage-2 ``CondTransformer`` trains its prior, a GPT over (B, T) codes
or an RQTransformer over an RQ-VAE's (B, T, D) residual codes, on the
frozen tokenizer's codes (``_build_stage2``: fp32 master weights,
``make_gpt_optimizer``), validating on ``val/total_loss``.

A Gumbel tokenizer (``ViTVQGumbel``) trains at the temperature
``model.temperature_scheduler(global_step)`` (without a scheduler the
quantizer's ``temp_init``; the last one in ``last_temp``) on noise keyed
by ``seed``: the Trainer splits one key per step off its running key, as
the JAX Trainer splits ``jax.random.PRNGKey(seed)``.

The stage-1 step always runs as the two phases of
``steps.make_vitvq_train_steps_split`` on the two halves of the step's
key, which is what the JAX Trainer's ``split_gan_step`` does in two
programs: here ``split_gan_step`` only refuses the adaptive adversarial
weight, as the JAX split step does. ``reuse_xrec`` (which implies it)
trains D on the AE phase's reconstruction. ``accumulate_grad_batches`` =
k makes every optimizer of either stage an ``optim.MultiSteps`` of k:
gradients averaged over k batches, one update every k steps, as
``optax.MultiSteps`` does.

Options the port cannot honour yet raise ``NotImplementedError``:
checkpoints (``basedir``, ``resume``; ROADMAP A7), meshes and parallelism
(``mesh``, ``zero1``, ``sp``, ``pipeline_parallel``; A9). The JAX
trainer's image-logger callbacks wait for A7.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..models.stage1.vitvqgan import ViTVQ
from ..models.stage2.layers import fp32_master_weights
from ..models.stage2.transformer import CondTransformer
from .optim import make_ae_optimizer, make_gpt_optimizer
from .steps import (GANTrainState, TrainState,
                    make_cond_transformer_eval_step,
                    make_cond_transformer_train_step, make_vitvq_eval_step,
                    make_vitvq_train_step, refuse_adaptive_weight,
                    split_key)


class Trainer:
    def __init__(self, max_epochs: int = 100, base_lr: float = 4.5e-6,
                 basedir: Optional[str] = None, seed: int = 0,
                 mesh=None, log_every: int = 50,
                 max_steps: Optional[int] = None,
                 split_gan_step: bool = False, reuse_xrec: bool = False,
                 metrics_logger=None, zero1: bool = False, sp: bool = False,
                 pipeline_parallel: int = 1, resume: bool = False,
                 accumulate_grad_batches: int = 1) -> None:
        # option -> (asked for, the ROADMAP.md item that ports it)
        unsupported = {
            "basedir (checkpoints)": (basedir is not None, "A7"),
            "resume": (resume, "A7"),
            "mesh": (mesh is not None, "A9"),
            "zero1": (zero1, "A9"),
            "sp": (sp, "A9"),
            "pipeline_parallel": (pipeline_parallel != 1, "A9"),
        }
        asked = [f"{name} (ROADMAP {item})"
                 for name, (on, item) in unsupported.items() if on]
        if asked:
            raise NotImplementedError(
                f"the port's Trainer does not support {asked} yet")
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be at least 1")
        self.max_epochs = max_epochs
        self.base_lr = base_lr
        # the running key of the per-step Gumbel noise
        self.seed = seed
        self.accumulate = accumulate_grad_batches
        # D trains on the AE phase's reconstruction instead of re-running
        # the generator forward — one SGD step stale; see
        # steps.make_vitvq_train_steps_split. Implies split_gan_step.
        self.reuse_xrec = reuse_xrec
        self.split_gan_step = split_gan_step or reuse_xrec
        self.last_temp: Optional[float] = None
        self.log_every = log_every
        self.max_steps = max_steps
        self.metrics_logger = metrics_logger
        self.global_step = 0
        self.last_log: Dict[str, Any] = {}

    def _scheduler(self, model):
        """The model config's LR scheduler, started at ``base_lr``."""
        if model.scheduler is None:
            return None
        from ..utils.config import initialize_from_config
        cfg = dict(model.scheduler)
        cfg["params"] = dict(cfg.get("params") or {}, start=self.base_lr)
        return initialize_from_config(cfg)

    def _build_stage1(self, model):
        loss_obj = model.loss
        if hasattr(loss_obj, "check_trainable"):
            loss_obj.check_trainable()
        sched = self._scheduler(model)
        state = GANTrainState(step=0, ae_opt=make_ae_optimizer(
            model.module.parameters(), self.base_lr, sched, self.accumulate))
        if getattr(loss_obj, "has_discriminator", False):
            state.disc_opt = make_ae_optimizer(
                loss_obj.discriminator.parameters(), self.base_lr, sched,
                self.accumulate)
        if self.split_gan_step:
            refuse_adaptive_weight(loss_obj)
        train_step = make_vitvq_train_step(model, loss_obj,
                                           reuse_xrec=self.reuse_xrec)
        return state, train_step, make_vitvq_eval_step(model, loss_obj)

    def _build_stage2(self, model: CondTransformer):
        """The prior's fp32 master weights, optimizer and steps (a GPT or
        an RQTransformer; any other prior raises before it is touched)."""
        prior = fp32_master_weights(model.transformer)
        opt = make_gpt_optimizer(prior, self.base_lr, self._scheduler(model),
                                 self.accumulate)
        return (TrainState(step=0, opt=opt),
                make_cond_transformer_train_step(model),
                make_cond_transformer_eval_step(model))

    def fit(self, model, data) -> None:
        if not isinstance(model, (ViTVQ, CondTransformer)):
            raise NotImplementedError(
                f"the port trains ViTVQ tokenizers and CondTransformer "
                f"priors, not {type(model).__name__}")
        data.setup()
        if isinstance(model, CondTransformer):
            self._fit_stage2(model, data)
        else:
            self._fit_stage1(model, data)

    def _fit_stage1(self, model, data) -> None:
        state, train_step, eval_step = self._build_stage1(model)
        do_r1_every = getattr(model.loss, "do_r1_every", 0)
        key = self.seed
        model.module.train()
        try:
            for epoch in range(self.max_epochs):
                for batch_idx, batch in enumerate(data.train_dataloader()):
                    x = model.get_input(batch, model.image_key)
                    do_r1 = bool(do_r1_every) and batch_idx % do_r1_every == 0
                    key, step_key = split_key(key)
                    self.last_temp = self._gumbel_temp(model)
                    log = train_step(state, x, do_r1=do_r1, rng=step_key,
                                     temp=self.last_temp)
                    self.last_log = log
                    self.global_step += 1
                    self._maybe_log(log, epoch)
                    if self.max_steps and self.global_step >= self.max_steps:
                        break
                self._validate(model, data, state, eval_step, epoch)
                if self.max_steps and self.global_step >= self.max_steps:
                    break
        finally:
            model.module.eval()
        self.final_state = state

    def _fit_stage2(self, model: CondTransformer, data) -> None:
        state, train_step, eval_step = self._build_stage2(model)
        for epoch in range(self.max_epochs):
            for batch in data.train_dataloader():
                log = train_step(state, *self._stage2_batch(model, batch))
                self.last_log = log
                self.global_step += 1
                self._maybe_log(log, epoch)
                if self.max_steps and self.global_step >= self.max_steps:
                    break
            self._validate(model, data, state, eval_step, epoch)
            if self.max_steps and self.global_step >= self.max_steps:
                break
        self.final_state = state

    @staticmethod
    def _stage2_batch(model: CondTransformer, batch):
        """(images (B, H, W, C), condition codes (B, T)) on the device."""
        stage1 = model.stage1_model
        return (stage1.get_input(batch, stage1.image_key),
                model.condition_codes(batch))

    def _validate(self, model, data, state, eval_step, epoch) -> None:
        if "validation" not in getattr(data, "datasets", {}):
            return
        if isinstance(model, CondTransformer):
            logs = [eval_step(state, *self._stage2_batch(model, batch))
                    for batch in data.val_dataloader()]
        else:
            logs = [eval_step(state, model.get_input(batch, model.image_key))
                    for batch in data.val_dataloader()]
        if logs:
            mean_log = {k: float(np.mean([float(l[k]) for l in logs]))
                        for k in logs[0]}
            self._print_metrics(mean_log, prefix=f"[epoch {epoch} val]")
            if self.metrics_logger is not None:
                self.metrics_logger.log_metrics(mean_log, self.global_step)

    def _gumbel_temp(self, model) -> float:
        """The temperature of the step at ``global_step``."""
        ts = getattr(model, "temperature_scheduler", None)
        if ts is not None:
            return float(ts(self.global_step))
        return float(getattr(model.module.quantizer, "temp_init", 1.0))

    def _maybe_log(self, log: Dict[str, Any], epoch: int) -> None:
        if self.global_step % self.log_every == 0:
            metrics = {k: float(v) for k, v in log.items()}
            self._print_metrics(
                metrics, prefix=f"[epoch {epoch} step {self.global_step}]")
            if self.metrics_logger is not None:
                self.metrics_logger.log_metrics(metrics, self.global_step)

    def _print_metrics(self, metrics: Dict[str, float], prefix: str) -> None:
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"{prefix} {parts}", flush=True)
