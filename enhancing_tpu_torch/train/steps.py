"""Training and validation steps: the stage-1 GAN and the stage-2 prior.

Counterpart of ``enhancing_tpu/train/steps.py:46-153, 254-376``. The
stage-2 steps (:func:`make_cond_transformer_train_step`,
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
One call of the stage-1 train step runs, in the JAX step's order:

1. the adaptive adversarial weight, when the loss asks for it: gradients
   of the reconstruction and GAN losses w.r.t. the reconstruction, chained
   onto the decoder's last layer with one einsum each;
2. the autoencoder update (AdamW) on the generator loss;
3. the discriminator update on a fresh reconstruction from the *updated*
   autoencoder, with ``disc_factor`` = (step >= disc_start), lazy R1 when
   ``do_r1``;
4. code perplexity and codes used of the AE phase's codes.

Gradients are taken with ``torch.autograd.grad`` w.r.t. one side's
parameters only, so the AE phase computes no discriminator weight
gradient, as ``jax.value_and_grad`` over the AE parameters does not. The
two-program variant (``make_vitvq_train_steps_split``, ``reuse_xrec``) and
Gumbel training are later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

Log = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The stage-2 prior's optimizer state and step counter; the parameters
    live in the prior."""

    step: int
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler


@dataclass
class GANTrainState:
    """Optimizer state and the step counter; the parameters live in the
    model's module and the loss's discriminator."""

    step: int
    ae_opt: torch.optim.Optimizer
    ae_sched: torch.optim.lr_scheduler.LRScheduler
    disc_opt: Optional[torch.optim.Optimizer] = None
    disc_sched: Optional[torch.optim.lr_scheduler.LRScheduler] = None


def code_perplexity(codes: torch.Tensor, n_embed: int):
    """exp(entropy) of the batch code histogram, and the codes used."""
    hist = torch.bincount(codes.reshape(-1).long(), minlength=n_embed).float()
    p = hist / torch.clamp(hist.sum(), min=1.0)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0))
    return torch.exp(ent), torch.sum(hist > 0)


def _update(params: List[torch.nn.Parameter], loss: torch.Tensor,
            opt: torch.optim.Optimizer,
            sched: torch.optim.lr_scheduler.LRScheduler) -> None:
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    sched.step()
    opt.zero_grad(set_to_none=True)


def make_vitvq_train_step(model, loss_obj) -> Callable[..., Log]:
    """The stage-1 train step ``train_step(state, x, do_r1=False) -> log``
    for a ``ViTVQ`` and its loss (``VQLPIPS`` or
    ``VQLPIPSWithDiscriminator``). It updates the parameters and ``state``
    in place; the log holds detached scalars."""
    module = model.module
    if module.quantizer_type != "vq":
        raise NotImplementedError(
            "Gumbel training (temperature schedule, noise) is a later slice "
            "of the port")
    has_disc = getattr(loss_obj, "has_discriminator", False)
    use_adaptive = getattr(loss_obj, "use_adaptive_adv", False)
    n_embed = module.quantizer.embedding.shape[0]
    ae_params = list(module.parameters())
    disc_params = list(loss_obj.discriminator.parameters()) if has_disc else []
    decoder = module.decoder

    def adaptive_d_weight(x: torch.Tensor) -> torch.Tensor:
        """||dnll/dW_last|| / ||dg/dW_last|| from gradients w.r.t. xrec."""
        with torch.no_grad():
            xrec, _, tokens, _ = module.forward_training(x)
        grads = []
        for fn in (lambda r: loss_obj.nll_loss(x, r)[0],
                   lambda r: loss_obj.disc_loss(loss_obj.discriminator(r))):
            r = xrec.detach().requires_grad_()
            (g,) = torch.autograd.grad(fn(r), r)
            grads.append(torch.einsum("bnd,bno->do", tokens.float(),
                                      decoder.patchify_grad(g).float()))
        return loss_obj.adaptive_weight(*grads)

    def train_step(state: GANTrainState, x: torch.Tensor,
                   do_r1: bool = False) -> Log:
        disc_factor = (float(state.step >= loss_obj.discriminator_iter_start)
                       if has_disc else 0.0)
        d_weight = adaptive_d_weight(x) if has_disc and use_adaptive else None

        # phase 0: autoencoder
        xrec, qloss, _, codes = module.forward_training(x)
        if has_disc:
            ae_loss, log = loss_obj.generator_loss(
                qloss, x, xrec, disc_factor, d_weight=d_weight)
        else:
            ae_loss, log = loss_obj.generator_loss(qloss, x, xrec)
        _update(ae_params, ae_loss, state.ae_opt, state.ae_sched)

        # phase 1: discriminator on the updated autoencoder's output
        if has_disc:
            with torch.no_grad():
                xrec2 = module.forward_training(x)[0]
            d_loss, d_log = loss_obj.discriminator_loss(x, xrec2, disc_factor,
                                                        do_r1=do_r1)
            _update(disc_params, d_loss, state.disc_opt, state.disc_sched)
            log.update(d_log)

        perp, n_used = code_perplexity(codes, n_embed)
        log["train/code_perplexity"] = perp
        log["train/codes_used"] = n_used
        state.step += 1
        return {k: torch.as_tensor(v).detach() for k, v in log.items()}

    return train_step


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
        _update(params, loss, state.opt, state.sched)
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
