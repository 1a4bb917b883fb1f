"""The training loop on one device.

Counterpart of ``enhancing_tpu/train/trainer.py``: ``fit(model,
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

With ``basedir`` the Trainer saves a checkpoint at the end of every
``checkpoint_every_epochs``-th epoch, after validation, into
``basedir/ckpt/<epoch>`` (``checkpoint.CheckpointDir``: written by
rename, every epoch kept), as the JAX Trainer saves through orbax. A
stage-1 checkpoint holds the step counter, the tokenizer's parameters and
buffers, the discriminator's (BatchNorm / ActNorm state included), the
frozen LPIPS, and each optimizer as ``checkpoint.multisteps_state`` has
it (AdamW moments, LR schedule, the accumulation's ``mini_step`` and
``acc``); a stage-2 one the step counter, the prior's fp32 master weights
and its optimizer (the frozen tokenizer is not trainable state, as JAX's
``CondTransformer.params`` is the prior's). ``resume=True`` restores the
newest checkpoint, sets ``global_step`` from its step counter and goes on
from the epoch after it, as JAX does. The running Gumbel key restarts
from ``seed`` at every ``fit`` and every epoch shuffles alike, as in JAX,
so a resumed VQ or prior run equals an uninterrupted one with the same
epoch boundaries, while a resumed Gumbel run repeats its first keys
(ROADMAP C, recorded numerics choices).

``callbacks`` are called as the JAX Trainer calls them:
``on_fit_start()`` where a callback has it, and every
``utils.callback.ImageLogger`` after each train step and on each
validation batch (``check_idx`` = the batch's index; ``top_k=64`` in
stage 2). ``use_amp`` is recorded, as in JAX: bf16 comes from the model
config (the CLI's ``-a``).

Meshes and parallelism (``mesh``, ``zero1``, ``sp``,
``pipeline_parallel``) are ROADMAP A9 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..models.stage1.vitvqgan import ViTVQ
from ..models.stage2.layers import fp32_master_weights
from ..models.stage2.transformer import CondTransformer
from ..utils.callback import ImageLogger, is_main_process
from .checkpoint import CheckpointDir, load_multisteps, multisteps_state
from .optim import make_ae_optimizer, make_gpt_optimizer
from .steps import (GANTrainState, TrainState,
                    make_cond_transformer_eval_step,
                    make_cond_transformer_train_step, make_vitvq_eval_step,
                    make_vitvq_train_step, refuse_adaptive_weight,
                    split_key)


class Trainer:
    def __init__(self, max_epochs: int = 100, base_lr: float = 4.5e-6,
                 use_amp: bool = False, accumulate_grad_batches: int = 1,
                 basedir: Optional[str] = None, seed: int = 0,
                 mesh=None, checkpoint_every_epochs: int = 1,
                 log_every: int = 50, callbacks: Optional[list] = None,
                 max_steps: Optional[int] = None,
                 split_gan_step: bool = False, reuse_xrec: bool = False,
                 metrics_logger=None, zero1: bool = False, sp: bool = False,
                 pipeline_parallel: int = 1, resume: bool = False) -> None:
        asked = [name for name, on in (
            ("mesh", mesh is not None), ("zero1", zero1), ("sp", sp),
            ("pipeline_parallel", pipeline_parallel != 1)) if on]
        if asked:
            raise NotImplementedError(
                f"the port's Trainer does not support {asked} yet: "
                f"multi-card training is ROADMAP A9")
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be at least 1")
        if checkpoint_every_epochs < 1:
            raise ValueError("checkpoint_every_epochs must be at least 1")
        self.max_epochs = max_epochs
        self.base_lr = base_lr
        self.use_amp = use_amp
        # the running key of the per-step Gumbel noise
        self.seed = seed
        self.accumulate = accumulate_grad_batches
        self.basedir = Path(basedir) if basedir else None
        self.checkpoint_every_epochs = checkpoint_every_epochs
        self.callbacks = callbacks or []
        # D trains on the AE phase's reconstruction instead of re-running
        # the generator forward — one SGD step stale; see
        # steps.make_vitvq_train_steps_split. Implies split_gan_step.
        self.reuse_xrec = reuse_xrec
        self.split_gan_step = split_gan_step or reuse_xrec
        self.last_temp: Optional[float] = None
        self.log_every = log_every
        self.max_steps = max_steps
        self.metrics_logger = metrics_logger
        self.resume = resume
        self.global_step = 0
        self.last_log: Dict[str, Any] = {}
        self.ckpt = (CheckpointDir(self.basedir / "ckpt")
                     if self.basedir is not None else None)
        # host clock: (epoch, path, seconds) of each save, the seconds of
        # the restore, and the end of each train step (after its logging
        # and callbacks)
        self.saves: list = []
        self.restore_seconds: Optional[float] = None
        self.step_ends: list = []

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
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_start"):
                cb.on_fit_start()
        data.setup()
        if isinstance(model, CondTransformer):
            self._fit_stage2(model, data)
        else:
            self._fit_stage1(model, data)

    def _image_loggers(self) -> list:
        return [cb for cb in self.callbacks if isinstance(cb, ImageLogger)]

    def _fit_stage1(self, model, data) -> None:
        state, train_step, eval_step = self._build_stage1(model)
        start_epoch = self._maybe_resume(model, state)
        do_r1_every = getattr(model.loss, "do_r1_every", 0)
        image_loggers = self._image_loggers()
        key = self.seed
        model.module.train()
        try:
            for epoch in range(start_epoch, self.max_epochs):
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
                    for il in image_loggers:
                        il.log_img(model, batch, self.global_step, "train")
                    self.step_ends.append(time.perf_counter())
                    if self.max_steps and self.global_step >= self.max_steps:
                        break
                self._validate(model, data, state, eval_step, epoch)
                self._save_ckpt(model, state, epoch)
                if self.max_steps and self.global_step >= self.max_steps:
                    break
        finally:
            model.module.eval()
        self.final_state = state

    def _fit_stage2(self, model: CondTransformer, data) -> None:
        state, train_step, eval_step = self._build_stage2(model)
        start_epoch = self._maybe_resume(model, state)
        image_loggers = self._image_loggers()
        for epoch in range(start_epoch, self.max_epochs):
            for batch in data.train_dataloader():
                log = train_step(state, *self._stage2_batch(model, batch))
                self.last_log = log
                self.global_step += 1
                self._maybe_log(log, epoch)
                for il in image_loggers:
                    il.log_img(model, batch, self.global_step, "train",
                               top_k=64)
                self.step_ends.append(time.perf_counter())
                if self.max_steps and self.global_step >= self.max_steps:
                    break
            self._validate(model, data, state, eval_step, epoch)
            self._save_ckpt(model, state, epoch)
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
        """Epoch-end validation: the mean of each logged value, and the
        image loggers on every validation batch."""
        if "validation" not in getattr(data, "datasets", {}):
            return
        stage2 = isinstance(model, CondTransformer)
        extra = {"top_k": 64} if stage2 else {}
        logs = []
        for batch_idx, batch in enumerate(data.val_dataloader()):
            if stage2:
                logs.append(eval_step(state,
                                      *self._stage2_batch(model, batch)))
            else:
                logs.append(eval_step(state, model.get_input(
                    batch, model.image_key)))
            for il in self._image_loggers():
                il.log_img(model, batch, self.global_step, "val",
                           check_idx=batch_idx, **extra)
        if logs:
            mean_log = {k: float(np.mean([float(l[k]) for l in logs]))
                        for k in logs[0]}
            self._print_metrics(mean_log, prefix=f"[epoch {epoch} val]")
            if self.metrics_logger is not None and is_main_process():
                self.metrics_logger.log_metrics(mean_log, self.global_step)

    # -- checkpoints ------------------------------------------------------------

    @staticmethod
    def _payload(model, state) -> Dict[str, Any]:
        """Everything a resumed run needs, as tensors and plain containers."""
        if isinstance(model, CondTransformer):
            return {"stage": 2, "step": state.step,
                    "params": model.transformer.state_dict(),
                    "opt": multisteps_state(state.opt)}
        loss = model.loss
        disc = (loss.discriminator
                if getattr(loss, "has_discriminator", False) else None)
        lpips = getattr(loss, "perceptual", None)
        return {"stage": 1, "step": state.step,
                "ae_params": model.module.state_dict(),
                "ae_opt": multisteps_state(state.ae_opt),
                "disc_params": None if disc is None else disc.state_dict(),
                "disc_opt": (None if state.disc_opt is None
                             else multisteps_state(state.disc_opt)),
                "lpips_params": None if lpips is None else lpips.state_dict()}

    @staticmethod
    def _load_payload(model, state, payload: Dict[str, Any]) -> None:
        if isinstance(model, CondTransformer):
            model.transformer.load_state_dict(payload["params"])
            load_multisteps(state.opt, payload["opt"])
        else:
            model.module.load_state_dict(payload["ae_params"])
            load_multisteps(state.ae_opt, payload["ae_opt"])
            if payload["disc_params"] is not None:
                model.loss.discriminator.load_state_dict(
                    payload["disc_params"])
                load_multisteps(state.disc_opt, payload["disc_opt"])
            if payload["lpips_params"] is not None:
                model.loss.perceptual.load_state_dict(
                    payload["lpips_params"])
        state.step = payload["step"]

    def _save_ckpt(self, model, state, epoch: int) -> None:
        if self.ckpt is None or (epoch + 1) % self.checkpoint_every_epochs:
            return
        if not is_main_process():
            return
        t0 = time.perf_counter()
        path = self.ckpt.save(epoch, self._payload(model, state))
        self.saves.append((epoch, path, time.perf_counter() - t0))

    def restore(self, step: Optional[int] = None,
                map_location="cpu") -> Dict[str, Any]:
        """The payload of checkpoint ``step`` (default: the newest)."""
        if self.ckpt is None:
            raise ValueError("restore needs a Trainer with basedir")
        return self.ckpt.load(step, map_location)

    def _maybe_resume(self, model, state) -> int:
        """Preemption recovery: restore the newest checkpoint in basedir
        into the model and ``state``, set ``global_step`` from its step
        counter, and return the epoch after it (0 with nothing to
        resume)."""
        if not self.resume or self.ckpt is None:
            return 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        t0 = time.perf_counter()
        self._load_payload(model, state, self.restore(latest, model.device))
        self.restore_seconds = time.perf_counter() - t0
        self.global_step = int(state.step)
        if is_main_process():
            print(f"[resume] epoch-{latest} checkpoint restored "
                  f"(global step {self.global_step})", flush=True)
        return latest + 1

    def _gumbel_temp(self, model) -> float:
        """The temperature of the step at ``global_step``."""
        ts = getattr(model, "temperature_scheduler", None)
        if ts is not None:
            return float(ts(self.global_step))
        return float(getattr(model.module.quantizer, "temp_init", 1.0))

    def _maybe_log(self, log: Dict[str, Any], epoch: int) -> None:
        if self.global_step % self.log_every == 0 and is_main_process():
            metrics = {k: float(v) for k, v in log.items()}
            self._print_metrics(
                metrics, prefix=f"[epoch {epoch} step {self.global_step}]")
            if self.metrics_logger is not None:
                self.metrics_logger.log_metrics(metrics, self.global_step)

    def _print_metrics(self, metrics: Dict[str, float], prefix: str) -> None:
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"{prefix} {parts}", flush=True)
