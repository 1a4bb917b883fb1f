"""Composite stage-1 losses: VQLPIPS and VQLPIPSWithDiscriminator.

Counterpart of ``enhancing_tpu/losses/vqperceptual.py:27-265``. The loss
is an ``nn.Module`` that owns its perceptual net (frozen) and its
discriminator, whose parameters the train step updates with their own
optimizer. R1 and the adaptive adversarial weight are taken with
``torch.autograd.grad``.

Lazy R1 differentiates the discriminator's input gradient a second time,
so it runs under ``ops.common.force_plain_ops``, as the JAX package runs
it under ``force_xla_ops`` (``:199-207``): the kernels' autograd
Functions give a first-order gradient only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.common import force_plain_ops
from .discriminator import StyleDiscriminator
from .gan import GAN_LOSSES
from .lpips import init_lpips

Log = Dict[str, torch.Tensor]


class DummyLoss(nn.Module):
    """No-op loss placeholder (the stage-2 configs' frozen tokenizers)."""

    def __init__(self, **kwargs) -> None:
        super().__init__()


class VQLPIPS(nn.Module):
    """Reconstruction + perceptual + codebook loss, no GAN. ``image_size``
    is the discriminator's default size; the JAX package also sizes its
    LPIPS initialisation with it, which the port's needs no size for."""

    has_discriminator = False

    def __init__(self, codebook_weight: float = 1.0,
                 loglaplace_weight: float = 1.0,
                 loggaussian_weight: float = 1.0,
                 perceptual_weight: float = 1.0,
                 lpips_weights: Optional[str] = None,
                 allow_random_lpips: bool = False,
                 image_size: int = 256, seed: int = 0) -> None:
        super().__init__()
        # the Trainer refuses to train against a random "LPIPS" unless the
        # config opts in (check_trainable); evaluation stays allowed
        self.lpips_is_random = bool(perceptual_weight > 0
                                    and not lpips_weights)
        self.allow_random_lpips = allow_random_lpips
        self.codebook_weight = codebook_weight
        self.loglaplace_weight = loglaplace_weight
        self.loggaussian_weight = loggaussian_weight
        self.perceptual_weight = perceptual_weight
        self.perceptual = init_lpips(
            lpips_weights, torch.Generator().manual_seed(seed))
        self.perceptual.requires_grad_(False)

    def check_trainable(self) -> None:
        """Raise unless training against this loss is metrically sound."""
        if self.lpips_is_random and not self.allow_random_lpips:
            raise ValueError(
                "perceptual_weight > 0 but no `lpips_weights` checkpoint was "
                "provided: the perceptual term would be a random-projection "
                "distance, not LPIPS — training would silently optimize a "
                "wrong objective. Pass `lpips_weights: <path to a torch "
                "vgg+lin checkpoint>` in the loss params, set "
                "`perceptual_weight: 0.0`, or opt in explicitly with "
                "`allow_random_lpips: true` (tests/smoke runs only).")

    def nll_loss(self, x: torch.Tensor, xrec: torch.Tensor
                 ) -> Tuple[torch.Tensor, Log]:
        loglaplace = torch.mean(torch.abs(xrec - x))
        loggaussian = torch.mean(torch.square(xrec - x))
        perceptual = torch.mean(self.perceptual(x * 2 - 1, xrec * 2 - 1))
        nll = (self.loglaplace_weight * loglaplace
               + self.loggaussian_weight * loggaussian
               + self.perceptual_weight * perceptual)
        return nll, {"loglaplace_loss": loglaplace,
                     "loggaussian_loss": loggaussian,
                     "perceptual_loss": perceptual}

    def generator_loss(self, codebook_loss, x, xrec, split: str = "train",
                       **_: Any) -> Tuple[torch.Tensor, Log]:
        nll, parts = self.nll_loss(x, xrec)
        loss = nll + self.codebook_weight * codebook_loss
        log = {f"{split}/total_loss": loss,
               f"{split}/quant_loss": codebook_loss,
               f"{split}/rec_loss": nll}
        log.update({f"{split}/{k}": v for k, v in parts.items()})
        return loss, log


class VQLPIPSWithDiscriminator(VQLPIPS):
    """VQLPIPS + StyleGAN adversarial term with lazy R1."""

    has_discriminator = True

    def __init__(self, disc_start: int = 0, disc_loss: str = "vanilla",
                 disc_params: Optional[dict] = None,
                 codebook_weight: float = 1.0,
                 loglaplace_weight: float = 1.0,
                 loggaussian_weight: float = 1.0,
                 perceptual_weight: float = 1.0,
                 adversarial_weight: float = 1.0,
                 use_adaptive_adv: bool = False,
                 r1_gamma: float = 10.0,
                 do_r1_every: int = 16,
                 r1_chunk: Optional[int] = None,
                 lpips_weights: Optional[str] = None,
                 allow_random_lpips: bool = False,
                 image_size: int = 256, seed: int = 0) -> None:
        super().__init__(codebook_weight, loglaplace_weight,
                         loggaussian_weight, perceptual_weight,
                         lpips_weights, allow_random_lpips, image_size, seed)
        if disc_loss not in GAN_LOSSES:
            raise ValueError(f"Unknown GAN loss '{disc_loss}'.")
        self.disc_loss = GAN_LOSSES[disc_loss]
        self.discriminator_iter_start = disc_start
        self.adversarial_weight = adversarial_weight
        self.use_adaptive_adv = use_adaptive_adv
        self.r1_gamma = r1_gamma
        self.do_r1_every = do_r1_every
        # R1 in sub-batches of r1_chunk images, whole minibatch-stddev
        # groups each, so the penalty equals the one-shot one; None = the
        # whole batch at once
        self.r1_chunk = r1_chunk
        disc_params = dict(disc_params or {})
        disc_params.setdefault("size", image_size)
        self.discriminator = StyleDiscriminator(
            generator=torch.Generator().manual_seed(seed + 1), **disc_params)

    def generator_loss(self, codebook_loss, x, xrec,
                       disc_factor: float | torch.Tensor = 1.0,
                       d_weight: Optional[torch.Tensor] = None,
                       split: str = "train", **_: Any
                       ) -> Tuple[torch.Tensor, Log]:
        """``disc_factor`` gates the adversarial term before
        ``disc_start``; ``d_weight`` overrides the static adversarial
        weight (the adaptive path)."""
        nll, parts = self.nll_loss(x, xrec)
        g_loss = self.disc_loss(self.discriminator(xrec))
        if d_weight is None:
            d_weight = torch.tensor(self.adversarial_weight,
                                    device=g_loss.device)
        loss = (nll + disc_factor * d_weight * g_loss
                + self.codebook_weight * codebook_loss)
        log = {f"{split}/total_loss": loss,
               f"{split}/quant_loss": codebook_loss,
               f"{split}/rec_loss": nll,
               f"{split}/g_loss": g_loss}
        log.update({f"{split}/{k}": v for k, v in parts.items()})
        if self.use_adaptive_adv:
            log[f"{split}/d_weight"] = d_weight
        return loss, log

    def discriminator_loss(self, x, xrec,
                           disc_factor: float | torch.Tensor = 1.0,
                           do_r1: bool = False, split: str = "train"
                           ) -> Tuple[torch.Tensor, Log]:
        logits_real = self.discriminator(x)
        logits_fake = self.discriminator(xrec.detach())
        d_loss = disc_factor * self.disc_loss(logits_fake, logits_real)
        log = {f"{split}/disc_loss": d_loss,
               f"{split}/logits_real": torch.mean(logits_real),
               f"{split}/logits_fake": torch.mean(logits_fake)}
        if do_r1:
            # lazy R1: d/dx sum(D(x)), squared norm per sample, scaled by
            # gamma * do_r1_every / 2; differentiated again by the step
            with force_plain_ops():
                grad_norm = torch.mean(self._r1_norms(x))
            d_loss = d_loss + self.r1_gamma * self.do_r1_every * grad_norm / 2
            log[f"{split}/r1_reg"] = grad_norm
            log[f"{split}/disc_loss"] = d_loss
        return d_loss, log

    def _sq_grad_norms(self, images: torch.Tensor) -> torch.Tensor:
        images = images.detach().requires_grad_()
        (g,) = torch.autograd.grad(self.discriminator(images).sum(), images,
                                   create_graph=True)
        return torch.sum(torch.square(g), dim=(1, 2, 3))

    def _r1_norms(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if not self.r1_chunk or b <= self.r1_chunk:
            return self._sq_grad_norms(x)
        # minibatch stddev couples the images of a group, and the groups
        # are strided over the batch; gather each group contiguous and run
        # D on one group at a time, which reproduces the full-batch
        # grouping (the JAX package vmaps over groups inside lax.map)
        group = min(b, 4)
        group = b // (b // group)
        if self.r1_chunk % group != 0 or b % self.r1_chunk != 0:
            raise ValueError(
                f"r1_chunk={self.r1_chunk} must divide the batch ({b}) and "
                f"be a multiple of the minibatch-stddev group size ({group})"
                ": the stddev channel couples images within a group, so "
                "only whole-group chunks keep chunked R1 identical to the "
                "one-shot penalty.")
        groups = x.reshape(group, b // group, *x.shape[1:]).movedim(0, 1)
        return torch.cat([self._sq_grad_norms(g) for g in groups])

    def adaptive_weight(self, nll_grad: torch.Tensor, g_grad: torch.Tensor
                        ) -> torch.Tensor:
        """||grad nll|| / (||grad g|| + 1e-4), clamped, with the gradients
        taken w.r.t. the decoder's last layer; no gradient flows."""
        factor = (torch.linalg.vector_norm(nll_grad)
                  / (torch.linalg.vector_norm(g_grad) + 1e-4))
        return (torch.clamp(factor, 0.0, 1e4)
                * self.adversarial_weight).detach()
