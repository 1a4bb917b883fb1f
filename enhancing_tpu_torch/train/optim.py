"""Optimizers and LR schedules for the stage-1 trainer.

Counterpart of ``enhancing_tpu/train/optim.py``: the schedulers are
step -> multiplier functions (copied, with Python floats in place of jnp),
and the stage-1 recipe is AdamW(betas=(0.9, 0.99), weight decay 1e-4)
for the autoencoder and for the discriminator, each with its own
``torch.optim.AdamW`` and a ``LambdaLR`` stepped once per update, so the
n-th update uses the multiplier of step n as optax evaluates it.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch


class BaseScheduler:
    """step -> multiplier (relative to the base LR)."""

    start: float

    def schedule(self, n):
        raise NotImplementedError

    def __call__(self, n):
        return self.schedule(n) * self.start


class ExponentialDecayScheduler(BaseScheduler):
    """exp(-scale*n), piecewise constant over ``decay_every_step`` steps,
    floored at ``end``."""

    def __init__(self, start: float, end: float, decay_every_step: int,
                 scale_factor: float) -> None:
        self.start, self.end = start, end
        self.decay_every_step = decay_every_step
        self.scale_factor = scale_factor

    def schedule(self, n):
        n_eff = math.floor(n / self.decay_every_step) * self.decay_every_step
        res = math.exp(-self.scale_factor * n_eff) * self.start
        return max(self.end, res) / self.start


class LambdaWarmUpCosineScheduler(BaseScheduler):
    """Linear warmup to max_, cosine decay to min_."""

    def __init__(self, warm_up_steps: int, max_decay_steps: int, min_: float,
                 max_: float, start: float = 1.0) -> None:
        assert max_decay_steps >= warm_up_steps
        self.warm_up_steps = warm_up_steps
        self.max_decay_steps = max_decay_steps
        self.min_, self.max_, self.start = min_, max_, start

    def schedule(self, n):
        if n < self.warm_up_steps:
            warm = ((self.max_ - self.start) / max(self.warm_up_steps, 1) * n
                    + self.start)
            return warm / self.start
        t = min(max((n - self.warm_up_steps)
                    / max(self.max_decay_steps - self.warm_up_steps, 1),
                    0.0), 1.0)
        decay = self.min_ + 0.5 * (self.max_ - self.min_) * (
            1 + math.cos(t * math.pi))
        return decay / self.start


class LambdaWarmUpLinearScheduler(BaseScheduler):
    """Linear warmup then linear decay."""

    def __init__(self, warm_up_steps: int, max_decay_steps: int, min_: float,
                 max_: float, start: float = 1.0) -> None:
        assert max_decay_steps >= warm_up_steps
        self.warm_up_steps = warm_up_steps
        self.max_decay_steps = max_decay_steps
        self.min_, self.max_, self.start = min_, max_, start

    def schedule(self, n):
        if n < self.warm_up_steps:
            warm = ((self.max_ - self.start) / max(self.warm_up_steps, 1) * n
                    + self.start)
            return warm / self.start
        decay = self.min_ + (self.max_ - self.min_) * min(max(
            (self.max_decay_steps - n) / max(self.max_decay_steps, 1), 0.),
            1.)
        return decay / self.start


def make_ae_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float,
                      scheduler: Optional[BaseScheduler] = None
                      ) -> Tuple[torch.optim.AdamW,
                                 torch.optim.lr_scheduler.LambdaLR]:
    """AdamW for the stage-1 autoencoder or discriminator, and its LR
    schedule (step the scheduler after every optimizer step)."""
    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.99), eps=1e-8,
                            weight_decay=1e-4)
    factor = scheduler.schedule if scheduler is not None else (lambda n: 1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
