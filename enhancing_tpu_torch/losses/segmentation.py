"""Segmentation losses for the ``VQSegmentation`` condition path.

Counterpart of ``enhancing_tpu/losses/segmentation.py``: targets are
one-hot label maps, reconstructions logits over the labels (NHWC), and
the binary cross-entropy is taken on the logits in the stable form
max(l, 0) - l t + log1p(exp(-|l|)). Neither loss has a discriminator, so
the stage-1 train step calls ``generator_loss(qloss, x, xrec)`` alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Log = Dict[str, torch.Tensor]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy of ``targets`` under ``logits``."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class BCELoss(nn.Module):
    """Binary cross-entropy on label maps."""

    has_discriminator = False

    def __init__(self, **kwargs) -> None:
        super().__init__()

    def forward(self, codebook_loss, inputs, reconstructions,
                split: str = "train") -> Tuple[torch.Tensor, Log]:
        loss = bce_with_logits(reconstructions, inputs)
        return loss, {f"{split}/total_loss": loss}

    def generator_loss(self, codebook_loss, inputs, reconstructions,
                       split: str = "train") -> Tuple[torch.Tensor, Log]:
        return self(codebook_loss, inputs, reconstructions, split)


class BCELossWithQuant(nn.Module):
    """Binary cross-entropy plus the weighted codebook loss."""

    has_discriminator = False

    def __init__(self, codebook_weight: float = 1.0, **kwargs) -> None:
        super().__init__()
        self.codebook_weight = codebook_weight

    def forward(self, codebook_loss, inputs, reconstructions,
                split: str = "train") -> Tuple[torch.Tensor, Log]:
        bce = bce_with_logits(reconstructions, inputs)
        loss = bce + self.codebook_weight * codebook_loss
        return loss, {f"{split}/total_loss": loss,
                      f"{split}/bce_loss": bce,
                      f"{split}/quant_loss": codebook_loss}

    def generator_loss(self, codebook_loss, inputs, reconstructions,
                       split: str = "train") -> Tuple[torch.Tensor, Log]:
        return self(codebook_loss, inputs, reconstructions, split)
