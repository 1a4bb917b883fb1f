"""LPIPS perceptual distance (VGG16 trunk), NHWC, in PyTorch.

Counterpart of ``enhancing_tpu/losses/lpips.py``:

- :class:`VGG16Features` is torchvision's VGG16 feature plan written
  with ``nn.Conv2d`` (the card's machine has no torchvision), returning
  the relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3 activations.
- :class:`LPIPS` shifts and scales its inputs with the lpips ScalingLayer
  constants, unit-normalises each stage's activations over channels,
  applies the 1x1 "lin" heads and averages over space, summed over the
  five stages.

:func:`init_lpips` loads pretrained weights from a torch file
(:func:`load_torch_lpips`: torchvision's VGG16 ``features.*`` convs and
the ``lpips`` package's lin heads), as the JAX package's
``load_torch_lpips`` does. No such file is in the repository; without
one it draws random weights and warns, as the JAX package does: the loss
is then a random-projection perceptual distance, not the published
metric.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .discriminator import conv2d_nhwc

# torchvision VGG16 conv plan: (out_channels, n_convs) per stage
VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# lpips ScalingLayer constants (shift/scale for inputs in [-1, 1])
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def _conv(in_ch: int, out_ch: int, k: int, bias: bool,
          generator: torch.Generator | None) -> nn.Conv2d:
    """nn.Conv2d with LeCun-normal weights (flax's default) and zero bias."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2, bias=bias,
                     device="meta")
    conv.weight = nn.Parameter(torch.randn(out_ch, in_ch, k, k,
                                           generator=generator)
                               / math.sqrt(in_ch * k * k))
    if bias:
        conv.bias = nn.Parameter(torch.zeros(out_ch))
    return conv


class VGG16Features(nn.Module):
    """VGG16 feature trunk returning the five LPIPS stages, NHWC."""

    def __init__(self, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.names = []
        in_ch = 3
        for s, (width, n_convs) in enumerate(VGG_PLAN):
            for c in range(n_convs):
                name = f"conv{s + 1}_{c + 1}"
                self.add_module(name, _conv(in_ch, width, 3, True, generator))
                self.names.append(name)
                in_ch = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for s, (_, n_convs) in enumerate(VGG_PLAN):
            for c in range(n_convs):
                conv = getattr(self, f"conv{s + 1}_{c + 1}")
                x = F.relu(conv2d_nhwc(x, conv.weight, padding=1) + conv.bias)
            feats.append(x)
            if s < len(VGG_PLAN) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """Learned perceptual distance between two NHWC images in [-1, 1]."""

    def __init__(self, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.net = VGG16Features(generator)
        for i, (width, _) in enumerate(VGG_PLAN):
            lin = nn.Conv2d(width, 1, 1, bias=False, device="meta")
            # lpips "lin" heads are non-negative: uniform in [0, 0.1)
            lin.weight = nn.Parameter(
                torch.rand(1, width, 1, 1, generator=generator) * 0.1)
            self.add_module(f"lin{i}", lin)
        self.register_buffer("shift", torch.tensor(SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample LPIPS distance, shape (B,)."""
        fx = self.net((x.float() - self.shift) / self.scale)
        fy = self.net((y.float() - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            diff = torch.square(_unit_normalize(a) - _unit_normalize(b))
            val = conv2d_nhwc(diff, getattr(self, f"lin{i}").weight)
            total = total + torch.mean(val, dim=(1, 2, 3))
        return total


# the indices of torchvision's 13 VGG16 convs in its ``features``
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def load_torch_lpips(lpips: LPIPS, path: str) -> LPIPS:
    """Copy a torch checkpoint into ``lpips``: torchvision's VGG16 conv
    weights and biases (``features.{0,2,5,...,28}.weight`` / ``.bias``,
    OIHW as the port stores them) and the ``lpips`` package's lin heads
    (``lin{i}.model.1.weight`` or ``lins.{i}.model.1.weight``, (1, C, 1,
    1)), with or without a ``state_dict`` wrapper. A missing or left-over
    key, or a shape mismatch, raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = dict(sd)
    targets = {}
    for idx, name in zip(TORCHVISION_CONVS, lpips.net.names):
        conv = getattr(lpips.net, name)
        targets[f"features.{idx}.weight"] = conv.weight
        targets[f"features.{idx}.bias"] = conv.bias
    for i in range(len(VGG_PLAN)):
        # the two names the lpips package gives a lin head's weight
        names = (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
        found = [k for k in names if k in sd]
        if len(found) != 1:
            raise KeyError(f"{path}: lin head {i} needs exactly one of "
                           f"{names}, found {found}")
        targets[found[0]] = getattr(lpips, f"lin{i}").weight
    missing = sorted(set(targets) - set(sd))
    extra = sorted(set(sd) - set(targets))
    if missing or extra:
        raise KeyError(f"{path}: missing keys {missing}, left-over keys "
                       f"{extra}")
    with torch.no_grad():
        for key, param in targets.items():
            value = torch.as_tensor(sd[key])
            if value.shape != param.shape:
                raise ValueError(f"{path}: {key} has shape "
                                 f"{tuple(value.shape)}, expected "
                                 f"{tuple(param.shape)}")
            param.copy_(value)
    return lpips


def init_lpips(weights_path: Optional[str] = None,
               generator: torch.Generator | None = None) -> LPIPS:
    """Build LPIPS and load ``weights_path`` (:func:`load_torch_lpips`);
    without a file, random weights from ``generator``, and a warning."""
    if weights_path:
        return load_torch_lpips(LPIPS(generator), weights_path)
    warnings.warn(
        "LPIPS running with randomly initialized VGG16 weights — "
        "perceptual loss is a random-projection distance, not the "
        "published LPIPS metric. Provide `lpips_weights` (a torch "
        "checkpoint with vgg + lin weights) for metric parity.")
    return LPIPS(generator)
