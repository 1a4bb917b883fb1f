"""Optimizers and LR schedules for the trainer.

Counterpart of ``enhancing_tpu/train/optim.py``: the schedulers are
step -> multiplier functions (copied, with Python floats in place of jnp),
and the two recipes, each a ``torch.optim.AdamW`` and a ``LambdaLR``
stepped once per update, so the n-th update uses the multiplier of step n
as optax evaluates it, both held by a :class:`MultiSteps`:

- stage 1: AdamW(betas=(0.9, 0.99), weight decay 1e-4) for the
  autoencoder and for the discriminator;
- the stage-2 priors (GPT and RQTransformer): the optax chain
  ``scale_by_adam(0.9, 0.96)`` ->
  ``add_decayed_weights(0.01, gpt_decay_mask)`` ->
  ``scale_by_learning_rate``, which is AdamW(betas=(0.9, 0.96), eps 1e-8)
  over two parameter groups, weight decay 0.01 and 0 (both subtract lr
  times the decay times the old parameter beside lr times the Adam step).
  The mask decides on each parameter's name in the JAX tree
  (:func:`gpt_jax_name`), with the JAX package's own pattern: the port's
  names (``tok_emb_code.weight``, ``ln1.weight``) would match it wrongly.

:class:`MultiSteps` is the counterpart of ``optax.MultiSteps(tx,
every_k_schedule=k)`` for ``accumulate`` = k: gradients are averaged over
k calls, and only the k-th call updates the parameters, the AdamW state
and the LR schedule; k = 1 updates on every call.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from ..models.stage2.layers import LayerNorm


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


class MultiSteps:
    """``optax.MultiSteps(every_k_schedule=every_k)`` around a torch
    optimizer and its LR schedule. Each call of :meth:`update` folds one
    gradient into a running mean (Welford's update, as optax's
    ``use_grad_mean``); calls 1 to k - 1 leave the parameters, the
    optimizer's state and the schedule as they are, and the k-th applies
    the mean through the optimizer and steps the schedule, which therefore
    counts real updates only. With ``every_k`` = 1 every call is an
    update on its own gradient."""

    def __init__(self, opt: torch.optim.Optimizer,
                 sched: torch.optim.lr_scheduler.LRScheduler,
                 every_k: int = 1) -> None:
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.opt, self.sched, self.every_k = opt, sched, every_k
        self.mini_step = 0
        self.acc: Optional[list] = None

    def update(self, params: Sequence[torch.nn.Parameter],
               grads: Sequence[torch.Tensor]) -> None:
        """Fold ``grads`` (fresh tensors, kept) into the mean; on the k-th
        call, take one optimizer step on ``params`` with it and one step
        of the LR schedule."""
        n = self.mini_step
        with torch.no_grad():
            if n == 0:
                self.acc = [g.detach() for g in grads]
            else:
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for p, g in zip(params, self.acc):
            p.grad = g
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)
        self.mini_step, self.acc = 0, None


def make_ae_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float,
                      scheduler: Optional[BaseScheduler] = None,
                      accumulate: int = 1) -> MultiSteps:
    """AdamW for the stage-1 autoencoder or discriminator and its LR
    schedule, in a :class:`MultiSteps` of ``accumulate`` calls an
    update."""
    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.99), eps=1e-8,
                            weight_decay=1e-4)
    return MultiSteps(opt, _lambda_lr(opt, scheduler), accumulate)


def _lambda_lr(opt: torch.optim.Optimizer,
               scheduler: Optional[BaseScheduler]
               ) -> torch.optim.lr_scheduler.LambdaLR:
    factor = scheduler.schedule if scheduler is not None else (lambda n: 1.0)
    return torch.optim.lr_scheduler.LambdaLR(opt, factor)


# the prior's weight decay, on the leaves that gpt_decay_mask marks
_GPT_WEIGHT_DECAY = 0.01

# the JAX package's no-decay pattern (enhancing_tpu/train/optim.py), matched
# against "/"-joined JAX tree paths
_NO_DECAY_PAT = re.compile(
    r"(bias$)|(^|/)(pos_emb_cond|pos_emb_code|pos_emb_depth|time_mix)"
    r"|(embedding$)|(scale$)|(layer_norm|ln1|ln2|ln_spatial|ln_depth|norm)"
)


def gpt_jax_name(gpt: nn.Module, name: str) -> str:
    """The path, "/"-joined, of the JAX prior's leaf (``scan_layers=False``:
    a GPT's ``blocks_{i}``, an RQTransformer's ``spatial_{i}`` and
    ``depth_{i}``) that the port's parameter ``name`` holds, as
    ``compat.load_gpt_from_jax`` and ``load_rq_from_jax`` map them: an
    ``nn.Embedding``'s weight is an ``embedding``, a LayerNorm's a
    ``scale``, a GEMM's a ``kernel``."""
    owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if leaf == "weight":
        module = gpt.get_submodule(owner)
        leaf = ("embedding" if isinstance(module, nn.Embedding) else
                "scale" if isinstance(module, LayerNorm) else "kernel")
    return "/".join([*owner.split("."), leaf] if owner else [leaf])


def gpt_decay_mask(gpt: nn.Module) -> Dict[str, bool]:
    """Port parameter name -> whether weight decay applies, the JAX
    ``gpt_decay_mask`` (the minGPT split) read on each leaf's JAX path."""
    return {name: _NO_DECAY_PAT.search(gpt_jax_name(gpt, name)) is None
            for name, _ in gpt.named_parameters()}


def make_gpt_optimizer(gpt: nn.Module, base_lr: float,
                       scheduler: Optional[BaseScheduler] = None,
                       accumulate: int = 1) -> MultiSteps:
    """AdamW(betas=(0.9, 0.96)) over the prior's parameters with weight
    decay where :func:`gpt_decay_mask` says and its LR schedule, in a
    :class:`MultiSteps` of ``accumulate`` calls an update."""
    mask = gpt_decay_mask(gpt)
    params = dict(gpt.named_parameters())
    groups = [{"params": [p for n, p in params.items() if mask[n] == decay],
               "weight_decay": _GPT_WEIGHT_DECAY if decay else 0.0}
              for decay in (True, False)]
    opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=base_lr,
                            betas=(0.9, 0.96), eps=1e-8)
    return MultiSteps(opt, _lambda_lr(opt, scheduler), accumulate)
