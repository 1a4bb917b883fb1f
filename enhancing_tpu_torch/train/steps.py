"""Training and validation steps: the stage-1 GAN and the stage-2 prior.

Counterpart of ``enhancing_tpu/train/steps.py``. The stage-2 steps
(:func:`make_cond_transformer_train_step`,
:func:`make_cond_transformer_eval_step`) encode the images with the frozen
tokenizer under ``torch.no_grad()`` (JAX's ``stop_gradient``), then take
the prior's fp32 cross-entropy (``CondTransformer.loss_fn``) and, in
training, its gradient w.r.t. the prior's parameters only and the AdamW
update. The prior is a GPT over (B, T) codes or an RQTransformer over
(B, T, D) residual codes, whose loss takes (B * T, D) targets. On CUDA
the prior's attention runs B8 forward and B5 backward
(``ops.multihead_attention_bnhd``); the RQ prior's depth window (4 tokens
at head dim 192 in the shipped config) takes the short route, the plain
version differentiated by autograd, as the JAX package's XLA path is.
One call of the fused stage-1 train step (:func:`make_vitvq_train_step`)
runs, in the JAX step's order:

1. the adaptive adversarial weight, when the loss asks for it: gradients
   of the reconstruction and GAN losses w.r.t. the reconstruction, chained
   onto the decoder's last layer with one einsum each;
2. the autoencoder update (AdamW) on the generator loss;
3. the discriminator update on a fresh reconstruction from the *updated*
   autoencoder, with ``disc_factor`` = (step >= disc_start), lazy R1 when
   ``do_r1``;
4. code perplexity and codes used of the AE phase's codes.

Steps 2 and 3 are the two phases :func:`make_vitvq_train_steps_split`
returns as ``(ae_step, disc_step)``; the fused step calls the same two in
turn. With ``reuse_xrec`` D trains on the AE phase's reconstruction
instead of a fresh one.

Gradients are taken with ``torch.autograd.grad`` w.r.t. one side's
parameters only, so the AE phase computes no discriminator weight
gradient, as ``jax.value_and_grad`` over the AE parameters does not. Each
optimizer is an ``optim.MultiSteps``: with gradient accumulation it moves
the parameters on every k-th call only; ``state.step``, which
``disc_start`` reads, advances on every call.

A Gumbel tokenizer (``ViTVQGumbel``) trains on noise at a temperature:
each stage-1 step takes an integer key ``rng`` and ``temp``. The fused
step splits the key in two (:func:`split_key`, where the JAX step calls
``jax.random.split``): the AE draw, which the adaptive-weight forward and
the AE phase share, and the D draw of the D phase's fresh reconstruction;
each forward draws from a ``torch.Generator`` on the model's device
seeded with its key (:func:`key_generator`). A VQ tokenizer draws nothing
and ignores both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .optim import MultiSteps

Log = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The stage-2 prior's optimizer (with its LR schedule) and step
    counter; the parameters live in the prior."""

    step: int
    opt: MultiSteps


@dataclass
class GANTrainState:
    """The optimizers (with their LR schedules) and the step counter; the
    parameters live in the model's module and the loss's discriminator."""

    step: int
    ae_opt: MultiSteps
    disc_opt: Optional[MultiSteps] = None


def split_key(key: Optional[int]) -> Tuple[Optional[int], Optional[int]]:
    """Two keys drawn from one (``jax.random.split``'s place); no key
    splits into two missing ones (a VQ tokenizer draws nothing)."""
    if key is None:
        return None, None
    gen = torch.Generator().manual_seed(key)
    first, second = torch.randint(0, 2 ** 62, (2,), generator=gen).tolist()
    return first, second


def key_generator(key: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``: one forward's draws."""
    return torch.Generator(device=device).manual_seed(key)


def code_perplexity(codes: torch.Tensor, n_embed: int):
    """exp(entropy) of the batch code histogram, and the codes used."""
    hist = torch.bincount(codes.reshape(-1).long(), minlength=n_embed).float()
    p = hist / torch.clamp(hist.sum(), min=1.0)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0))
    return torch.exp(ent), torch.sum(hist > 0)


def _update(params: List[torch.nn.Parameter], loss: torch.Tensor,
            opt: MultiSteps) -> None:
    opt.update(params, torch.autograd.grad(loss, params, allow_unused=True,
                                           materialize_grads=True))


def _detached(log: Log) -> Log:
    return {k: torch.as_tensor(v).detach() for k, v in log.items()}


def _gan_phases(model, loss_obj):
    """The two phases of the stage-1 step, ``(ae_phase, disc_phase)``,
    and the adaptive adversarial weight's function.

    ``ae_phase(state, x, key, temp, d_weight=None) -> (log, xrec, codes
    used)`` updates the autoencoder and logs its losses and the code
    perplexity; ``xrec`` is its reconstruction, detached.
    ``disc_phase(state, x, rng=None, temp=None, do_r1=False, xrec=None) ->
    log`` updates the discriminator on ``xrec`` or, without it, on a fresh
    reconstruction from the updated autoencoder, and alone advances
    ``state.step``. A Gumbel tokenizer's forward draws its noise from
    ``key`` (``rng``)."""
    module = model.module
    is_gumbel = module.quantizer_type == "gumbel"
    has_disc = getattr(loss_obj, "has_discriminator", False)
    n_embed = module.quantizer.embedding.shape[0]
    ae_params = list(module.parameters())
    disc_params = list(loss_obj.discriminator.parameters()) if has_disc else []
    decoder = module.decoder

    def forward(x: torch.Tensor, temp: Optional[float], key: Optional[int]):
        if not is_gumbel:
            return module.forward_training(x)
        if key is None:
            raise ValueError("a Gumbel tokenizer's train step draws noise: "
                             "pass a key (rng)")
        return module.forward_training(x, temp, False,
                                       key_generator(key, x.device))

    def disc_factor(state) -> float:
        return (float(state.step >= loss_obj.discriminator_iter_start)
                if has_disc else 0.0)

    def adaptive_d_weight(x: torch.Tensor, temp, key) -> torch.Tensor:
        """||dnll/dW_last|| / ||dg/dW_last|| from gradients w.r.t. xrec."""
        with torch.no_grad():
            xrec, _, tokens, _ = forward(x, temp, key)
        grads = []
        for fn in (lambda r: loss_obj.nll_loss(x, r)[0],
                   lambda r: loss_obj.disc_loss(loss_obj.discriminator(r))):
            r = xrec.detach().requires_grad_()
            (g,) = torch.autograd.grad(fn(r), r)
            grads.append(torch.einsum("bnd,bno->do", tokens.float(),
                                      decoder.patchify_grad(g).float()))
        return loss_obj.adaptive_weight(*grads)

    def ae_phase(state, x: torch.Tensor, key: Optional[int],
                 temp: Optional[float], d_weight=None):
        xrec, qloss, _, codes = forward(x, temp, key)
        if has_disc:
            ae_loss, log = loss_obj.generator_loss(
                qloss, x, xrec, disc_factor(state), d_weight=d_weight)
        else:
            ae_loss, log = loss_obj.generator_loss(qloss, x, xrec)
        _update(ae_params, ae_loss, state.ae_opt)
        log["train/code_perplexity"], n_used = code_perplexity(codes,
                                                               n_embed)
        return _detached(log), xrec.detach(), n_used

    def disc_phase(state, x: torch.Tensor, rng: Optional[int] = None,
                   temp: Optional[float] = None, do_r1: bool = False,
                   xrec: Optional[torch.Tensor] = None) -> Log:
        if not has_disc:
            state.step += 1
            return {}
        if xrec is None:
            with torch.no_grad():
                xrec = forward(x, temp, rng)[0]
        d_loss, d_log = loss_obj.discriminator_loss(
            x, xrec, disc_factor(state), do_r1=do_r1)
        _update(disc_params, d_loss, state.disc_opt)
        state.step += 1
        return _detached(d_log)

    adaptive = (adaptive_d_weight
                if has_disc and getattr(loss_obj, "use_adaptive_adv", False)
                else None)
    return ae_phase, disc_phase, adaptive


def refuse_adaptive_weight(loss_obj) -> None:
    """The split step's refusal of the adaptive adversarial weight."""
    if getattr(loss_obj, "use_adaptive_adv", False):
        raise NotImplementedError(
            "use_adaptive_adv requires the fused train step "
            "(Trainer(split_gan_step=False))")


def make_vitvq_train_step(model, loss_obj,
                          reuse_xrec: bool = False) -> Callable[..., Log]:
    """The stage-1 train step ``train_step(state, x, do_r1=False, rng=None,
    temp=None) -> log`` for a ``ViTVQ`` (or ``ViTVQGumbel``: ``rng`` an
    integer key, ``temp`` the temperature) and its loss (``VQLPIPS``,
    ``VQLPIPSWithDiscriminator`` or a segmentation loss): the two phases
    of :func:`make_vitvq_train_steps_split` on the two halves of ``rng``.
    It updates the parameters and ``state`` in place; the log holds
    detached scalars. ``reuse_xrec`` is the split step's (which see); it
    cannot take the adaptive weight."""
    if reuse_xrec:
        refuse_adaptive_weight(loss_obj)
    ae_phase, disc_phase, adaptive_d_weight = _gan_phases(model, loss_obj)

    def train_step(state: GANTrainState, x: torch.Tensor,
                   do_r1: bool = False, rng: Optional[int] = None,
                   temp: Optional[float] = None) -> Log:
        key_ae, key_d = split_key(rng)
        d_weight = (adaptive_d_weight(x, temp, key_ae)
                    if adaptive_d_weight is not None else None)
        log, xrec, n_used = ae_phase(state, x, key_ae, temp, d_weight)
        log.update(disc_phase(state, x, key_d, temp, do_r1,
                              xrec if reuse_xrec else None))
        log["train/codes_used"] = n_used
        return log

    return train_step


def make_vitvq_train_steps_split(model, loss_obj, reuse_xrec: bool = False):
    """Two-step variant of the GAN step: ``(ae_step, disc_step)``.

    ``ae_step(state, x, rng=None, temp=None) -> log`` updates the
    autoencoder and logs its losses and the code perplexity;
    ``disc_step(state, x, rng=None, temp=None, do_r1=False, xrec=None) ->
    log`` updates the discriminator on a fresh reconstruction from the
    updated autoencoder and alone advances ``state.step``. Each takes its
    own key; called in turn with the two halves of one step's key they do
    what :func:`make_vitvq_train_step` does. The adaptive adversarial
    weight needs the fused step and raises here, as in the JAX package.

    ``reuse_xrec=True`` changes the protocol AND the semantics: ae_step
    returns ``(log, xrec)`` with the reconstruction it already computed
    (detached), and ``disc_step(..., xrec=...)`` trains D on it instead of
    re-running the generator forward. That saves one full generator
    forward per step, but D then sees the PRE-update generator's output —
    the reference recomputes xrec after the G optimizer step (Lightning's
    sequential optimizers), so D there sees a half-step-fresher fake. One
    SGD step of staleness on the fake distribution; opt-in.
    """
    refuse_adaptive_weight(loss_obj)
    ae_phase, disc_phase, _ = _gan_phases(model, loss_obj)

    def ae_step(state: GANTrainState, x: torch.Tensor,
                rng: Optional[int] = None, temp: Optional[float] = None):
        log, xrec, _ = ae_phase(state, x, rng, temp)
        return (log, xrec) if reuse_xrec else log

    return ae_step, disc_phase


def make_vitvq_eval_step(model, loss_obj) -> Callable[..., Log]:
    """Validation metrics ``eval_step(state, x) -> log``, without grad."""
    module = model.module
    has_disc = getattr(loss_obj, "has_discriminator", False)

    @torch.no_grad()
    def eval_step(state: GANTrainState, x: torch.Tensor) -> Log:
        xrec, qloss = module(x)
        if has_disc:
            disc_factor = float(state.step >= loss_obj.discriminator_iter_start)
            _, log = loss_obj.generator_loss(qloss, x, xrec, disc_factor,
                                             split="val")
            _, d_log = loss_obj.discriminator_loss(x, xrec, disc_factor,
                                                   do_r1=False, split="val")
            log.update(d_log)
        else:
            _, log = loss_obj.generator_loss(qloss, x, xrec, split="val")
        return log

    return eval_step


def _frozen_codes(cond_model, images: torch.Tensor) -> torch.Tensor:
    """The frozen tokenizer's codes of ``images``, outside any graph."""
    with torch.no_grad():
        return cond_model.stage1_model.module.encode_codes(images)


def make_cond_transformer_train_step(cond_model) -> Callable[..., Log]:
    """The stage-2 prior step ``train_step(state, images, conds) -> log``:
    frozen encode of ``images`` (B, H, W, C), cross-entropy of the prior on
    the codes given the condition codes ``conds`` (B, T), and the update of
    the prior's parameters by ``state.opt`` (AdamW, ``make_gpt_optimizer``).
    Logs ``train/total_loss``."""
    params = list(cond_model.transformer.parameters())

    def train_step(state: TrainState, images: torch.Tensor,
                   conds: torch.Tensor) -> Log:
        loss = cond_model.loss_fn(_frozen_codes(cond_model, images), conds)
        _update(params, loss, state.opt)
        state.step += 1
        return {"train/total_loss": loss.detach()}

    return train_step


def make_cond_transformer_eval_step(cond_model) -> Callable[..., Log]:
    """Validation ``eval_step(state, images, conds) -> log``: the prior's
    cross-entropy on the frozen tokenizer's codes, ``val/total_loss``."""

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor,
                  conds: torch.Tensor) -> Log:
        codes = _frozen_codes(cond_model, images)
        return {"val/total_loss": cond_model.loss_fn(codes, conds)}

    return eval_step
