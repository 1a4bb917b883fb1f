"""StyleGAN2 discriminator, NHWC, in PyTorch.

Counterpart of ``enhancing_tpu/losses/discriminator.py:25-191``.
Equalized-LR layers draw their weights from N(0, 1) and apply the He
constant 1/sqrt(fan_in) at run time; the blur before each strided conv
runs through ``ops.upfirdn2d`` and the bias + leaky ReLU through
``ops.fused_act`` (the kernels ``csrc/fir.cu`` and ``csrc/fused_act.cu``
on the card). Activations stay NHWC: each convolution reads them as a
channels-last NCHW view, so no layout copy is made.

Convolution weights are stored OIHW (``F.conv2d``'s layout) and linear
weights (out, in); ``compat.from_jax`` transposes the JAX HWIO and
(in, out) arrays on the copy. Submodules carry the JAX names (``stem``,
``block_{i}.conv1``, ``final_linear1``, ...).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.stage1.vitvqgan import DTYPES
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import make_blur_kernel, upfirdn2d


def _dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """F.conv2d of an NHWC tensor (read as a channels-last NCHW view) with
    an OIHW weight; returns NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride,
                   padding=padding)
    return out.permute(0, 2, 3, 1)


class EqualConv2d(nn.Module):
    """Conv with run-time 1/sqrt(fan_in) scaling."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True, *,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, k,
                                               k, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channels * k * k)
        self.stride, self.padding = stride, padding
        self.dtype = _dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d_nhwc(x.to(self.dtype),
                          (self.weight * self.scale).to(self.dtype),
                          self.stride, self.padding)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class EqualLinear(nn.Module):
    """Linear with run-time scaling and an optional fused leaky ReLU."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 bias_init_val: float = 0.0, lr_mul: float = 1.0,
                 activation: Optional[str] = None, *, dtype=torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            out_features, in_features, generator=generator) / lr_mul)
        self.bias = (nn.Parameter(torch.full((out_features,), bias_init_val))
                     if bias else None)
        self.scale = (1.0 / math.sqrt(in_features)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation
        self.dtype = _dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype) @ (self.weight * self.scale).to(self.dtype).t()
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        if self.bias is not None:
            out = out + (self.bias * self.lr_mul).to(self.dtype)
        return out


class ConvLayer(nn.Module):
    """[Blur ->] EqualConv2d [-> fused bias + leaky ReLU]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), bias: bool = True,
                 activate: bool = True, *, dtype=torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.downsample = downsample
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2, p // 2)
            # a host tensor, not a buffer: the blur bakes its taps into
            # the kernel launch, so it never moves to the card
            self.blur = make_blur_kernel(list(blur_kernel))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv2d(in_channels, out_channels, kernel_size,
                                stride, padding, bias=bias and not activate,
                                dtype=dtype, generator=generator)
        self.activate = activate
        if activate and bias:
            self.act_bias = nn.Parameter(torch.zeros(out_channels))
        elif activate:
            self.register_buffer("act_bias", torch.zeros(out_channels),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = upfirdn2d(x, self.blur, pad=self.blur_pad)
        x = self.conv(x)
        if self.activate:
            x = fused_leaky_relu(x, self.act_bias)
        return x


class StyleBlock(nn.Module):
    """Residual downsample block, skip scaled by 1/sqrt(2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), *,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        kw = dict(blur_kernel=blur_kernel, dtype=dtype, generator=generator)
        self.conv1 = ConvLayer(in_channels, in_channels, 3, **kw)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               **kw)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              activate=False, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2.0)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_new_features: int = 1) -> torch.Tensor:
    """Append the per-group feature stddev as an extra channel. Groups are
    strided over the batch (image i is in group i % (B / group)), as the
    (group, -1) reshape makes them. x: (B, H, W, C)."""
    b, h, w, c = x.shape
    group = min(b, group_size)
    group = b // (b // group)
    y = x.reshape(group, -1, h, w, num_new_features, c // num_new_features)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8)
    std = torch.mean(std, dim=(1, 2, 4), keepdim=True)[..., 0]
    std = std.repeat(group, h, w, 1)
    return torch.cat([x, std.to(x.dtype)], dim=-1)


class StyleDiscriminator(nn.Module):
    """StyleGAN2 discriminator over NHWC RGB images of ``size`` pixels."""

    def __init__(self, size: int = 256, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype="float32", *,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        cm = channel_multiplier
        channels = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm,
                    128: 128 * cm, 256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
        kw = dict(dtype=dtype, generator=generator)
        self.stem = ConvLayer(3, channels[size], 1, **kw)
        in_ch = channels[size]
        self.block_names = []
        for i in range(int(math.log2(size)), 2, -1):
            out_ch = channels[2 ** (i - 1)]
            self.add_module(f"block_{i}", StyleBlock(in_ch, out_ch,
                                                     blur_kernel, **kw))
            self.block_names.append(f"block_{i}")
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + 1, channels[4], 3, **kw)
        self.final_linear1 = EqualLinear(channels[4] * 4 * 4, channels[4],
                                         activation="fused_lrelu", **kw)
        self.final_linear2 = EqualLinear(channels[4], 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.stem(x)
        for name in self.block_names:
            out = getattr(self, name)(out)
        out = self.final_conv(minibatch_stddev(out))
        out = self.final_linear1(out.reshape(out.shape[0], -1))
        return self.final_linear2(out)[:, 0]
