"""GAN loss functions: hinge / vanilla (softplus) / least-square.

Counterpart of ``enhancing_tpu/losses/gan.py``. Each handles both modes:
generator (``logits_real is None``) and discriminator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_fake: torch.Tensor,
                 logits_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    if logits_real is None:
        loss_fake = -torch.mean(logits_fake) * 2
        loss_real = 0.0
    else:
        loss_fake = torch.mean(F.relu(1.0 + logits_fake))
        loss_real = torch.mean(F.relu(1.0 - logits_real))
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_fake: torch.Tensor,
                   logits_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    if logits_real is None:
        loss_fake = torch.mean(F.softplus(-logits_fake)) * 2
        loss_real = 0.0
    else:
        loss_fake = torch.mean(F.softplus(logits_fake))
        loss_real = torch.mean(F.softplus(-logits_real))
    return 0.5 * (loss_real + loss_fake)


def least_square_d_loss(logits_fake: torch.Tensor,
                        logits_real: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    if logits_real is None:
        loss_fake = torch.mean(torch.square(logits_fake)) * 2
        loss_real = 0.0
    else:
        loss_fake = torch.mean(torch.square(1.0 + logits_fake))
        loss_real = torch.mean(torch.square(1.0 - logits_real))
    return 0.5 * (loss_real + loss_fake)


GAN_LOSSES = {
    "hinge": hinge_d_loss,
    "vanilla": vanilla_d_loss,
    "least_square": least_square_d_loss,
}
