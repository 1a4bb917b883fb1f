"""InceptionV3 pool3 (2048-d) features for FID, as an ``nn.Module``.

Counterpart of ``enhancing_tpu/eval/inception.py``: torchvision's
``inception_v3`` up to the global average pool with pytorch-fid's patches
(the avg-pool branches of the A, C and E blocks use
``count_include_pad=False``; the last InceptionE block pools its branch
with a max-pool). Submodules carry torchvision's names (``Mixed_5b.
branch_pool.conv.weight``, ``.bn.running_mean``, ...), so a
torchvision-layout state dict, the pytorch-fid ``pt_inception-2015-12-05``
export among them, loads with ``load_state_dict(strict=True)`` once its
classifier (``fc.*``, ``AuxLogits.*``) is dropped
(:func:`load_torch_inception`). BatchNorm runs on its running statistics
(eps 1e-3): the module is inference-only and stays in eval mode.

Inputs are NHWC in [-1, 1] at 299 px, moved to NCHW for the library's
convolutions (cuDNN on the card; the JAX package's are XLA's, and no
Pallas kernel is involved). :func:`fid_feature_fn` is the [0, 1] image ->
bilinear resize to 299 (``antialias=False``, ``align_corners=False``, as
pytorch-fid) -> [-1, 1] -> features pipeline. No FID weights are in the
repository: :func:`init_inception` without ``weights_path`` draws random
weights from a seed.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import resolve_device

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (running stats) + ReLU: torchvision's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor, fid_variant: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid_variant)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int,
                 fid_variant: bool = True) -> None:
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int,
                 fid_variant: bool = True) -> None:
        super().__init__()
        c7 = channels_7x7
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_kind: str = "avg",
                 fid_variant: bool = True) -> None:
        super().__init__()
        # pytorch-fid: 'avg' for Mixed_7b, 'max' for Mixed_7c
        self.pool_kind = pool_kind
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_kind == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Pool3(nn.Module):
    """The feature trunk up to the 2048-d global average pool (no
    classifier). Input: NHWC in [-1, 1] at 299 x 299."""

    def __init__(self, fid_variant: bool = True) -> None:
        super().__init__()
        v = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32, v)
        self.Mixed_5c = InceptionA(256, 64, v)
        self.Mixed_5d = InceptionA(288, 64, v)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, v)
        self.Mixed_6c = InceptionC(768, 160, v)
        self.Mixed_6d = InceptionC(768, 160, v)
        self.Mixed_6e = InceptionC(768, 192, v)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", v)
        self.Mixed_7c = InceptionE(2048, "max" if v else "avg", v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


# keys of a torchvision state dict outside the pool3 trunk
_HEAD_PREFIXES: Sequence[str] = ("fc.", "AuxLogits.")


def load_torch_inception(path_or_sd, module: InceptionV3Pool3
                         ) -> InceptionV3Pool3:
    """Load a torchvision-layout InceptionV3 state dict (a file, with or
    without a ``state_dict`` wrapper, or a dict) into ``module`` with
    ``load_state_dict(strict=True)``, its ``fc.*`` / ``AuxLogits.*`` keys
    dropped. A missing or left-over trunk key, or a shape mismatch,
    raises."""
    if isinstance(path_or_sd, dict):
        sd = path_or_sd
    else:
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if not k.startswith(_HEAD_PREFIXES)}
    module.load_state_dict(sd, strict=True)
    return module


def _draw(module: InceptionV3Pool3, generator: torch.Generator) -> None:
    """LeCun-normal conv kernels (flax's default, the JAX module's init),
    BatchNorm at identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               / math.sqrt(fan_in))


def init_inception(weights_path: Optional[str] = None,
                   fid_variant: bool = True, seed: int = 0,
                   device: str | torch.device | None = None
                   ) -> InceptionV3Pool3:
    """The trunk on ``device`` (default ``cuda``), in eval mode: weights
    from ``weights_path`` (:func:`load_torch_inception`), else drawn from
    ``seed``."""
    module = InceptionV3Pool3(fid_variant)
    if weights_path:
        load_torch_inception(weights_path, module)
    else:
        _draw(module, torch.Generator().manual_seed(seed))
    return module.to(resolve_device(device)).eval()


def resize_299(images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> NHWC at 299 x 299, bilinear without antialiasing
    (``jax.image.resize(..., 'bilinear', antialias=False)``)."""
    x = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(299, 299),
                      mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def fid_feature_fn(module: InceptionV3Pool3
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[0, 1] NHWC images (any size) -> 2048-d pool3 features."""
    device = next(module.parameters()).device

    @torch.no_grad()
    def fn(images) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        return module(resize_299(images) * 2.0 - 1.0)
    return fn
