"""StyleGAN2 discriminator, NHWC, in PyTorch.

Counterpart of ``enhancing_tpu/losses/discriminator.py``.
Equalized-LR layers draw their weights from N(0, 1) and apply the He
constant 1/sqrt(fan_in) at run time; the blur before each strided conv
runs through ``ops.upfirdn2d`` and the bias + leaky ReLU through
``ops.fused_act`` (the kernels ``csrc/fir.cu`` and ``csrc/fused_act.cu``
on the card). Activations stay NHWC: each convolution reads them as a
channels-last NCHW view, so no layout copy is made.

:class:`PatchDiscriminator` (with :class:`BatchNorm` or :class:`ActNorm`)
is the counterpart of ``discriminator.py:194-281``; no loss of the JAX
package builds it, so it runs on no training path.

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


class ActNorm(nn.Module):
    """Activation normalisation with a data-dependent init, NHWC (or (B, C)).
    ``loc``, ``scale`` and ``initialized`` are buffers, as the JAX
    package's ``batch_stats``: the first call with ``train=True`` sets loc
    to minus each channel's mean and scale to 1 / (its std (ddof=1) +
    1e-6), and that call's output already uses them (its gradient flows
    through the batch statistics, as in JAX); they stay fixed after.
    With ``logdet`` it also returns H * W * sum(log |scale|) per sample."""

    def __init__(self, num_features: int, logdet: bool = False) -> None:
        super().__init__()
        self.num_features = num_features
        self.logdet = logdet
        shape = (1, 1, 1, num_features)
        self.register_buffer("loc", torch.zeros(shape))
        self.register_buffer("scale", torch.ones(shape))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.uint8))

    def forward(self, x: torch.Tensor, train: bool = False):
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, None, :]
        loc, scale = self.loc, self.scale
        if train:
            flat = x.permute(3, 0, 1, 2).reshape(self.num_features, -1)
            mean = torch.mean(flat, dim=1).reshape(loc.shape)
            std = torch.std(flat, dim=1, correction=1).reshape(loc.shape)
            first = self.initialized == 0
            loc = torch.where(first, -mean, loc)
            scale = torch.where(first, 1.0 / (std + 1e-6), scale)
            with torch.no_grad():
                self.loc.copy_(loc)
                self.scale.copy_(scale)
                self.initialized.fill_(1)
        h = scale * (x + loc)
        if squeeze:
            h = h[:, 0, 0, :]
        if self.logdet:
            hw = x.shape[1] * x.shape[2]
            logdet = hw * torch.sum(torch.log(torch.abs(scale)))
            return h, logdet * torch.ones(x.shape[0], device=x.device)
        return h


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the last axis, written out: batch
    statistics in fp32 (the variance as E[x^2] - E[x]^2, clipped at 0, the
    biased one) under ``train=True``, whose running averages take momentum
    0.99 (torch's 0.01) and keep that biased variance; the running ones
    otherwise; eps 1e-5. ``weight`` is flax's ``scale``, drawn as the JAX
    package's ``normal(1.0, 0.02)`` draws it (stddev 1, its second
    argument being a dtype)."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5, *,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.randn(num_features,
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = torch.mean(xf, dim=dims)
            var = torch.clamp_min(torch.mean(xf * xf, dim=dims)
                                  - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum)
                                                   * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class _Conv(nn.Module):
    """A plain NHWC convolution (flax ``nn.Conv``), OIHW weight drawn from
    N(0, 0.02), zero bias."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bias: bool, dtype: torch.dtype,
                 generator: torch.Generator | None) -> None:
        super().__init__()
        self.weight = nn.Parameter(0.02 * torch.randn(
            out_channels, in_channels, 4, 4, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.stride, self.dtype = stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                          self.stride, padding=1)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


def _leaky(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 0, h, 0.2 * h)


class PatchDiscriminator(nn.Module):
    """Pix2Pix PatchGAN discriminator, NHWC: 4x4 convolutions (stride 2,
    then 1) with padding 1 and leaky ReLU 0.2, BatchNorm (or ActNorm with
    ``use_actnorm``) after every convolution but the first and the last.
    ``forward(x, train)``: ``train=True`` normalises with the batch's
    statistics and updates the running ones (ActNorm: its first-batch
    init). Submodules carry the JAX names (``conv0``, ``norm1``, ...,
    ``conv_out``); ``compat.load_patch_discriminator_from_jax`` fills the
    parameters and the ``batch_stats`` buffers."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, dtype="float32", *,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.n_layers = n_layers
        dtype = _dtype(dtype)

        def norm(features):
            return (ActNorm(features) if use_actnorm
                    else BatchNorm(features, generator=generator))

        self.conv0 = _Conv(input_nc, ndf, 2, True, dtype, generator)
        in_ch = ndf
        for n in range(1, n_layers + 1):
            out_ch = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", _Conv(in_ch, out_ch,
                                              2 if n < n_layers else 1,
                                              use_actnorm, dtype, generator))
            self.add_module(f"norm{n}", norm(out_ch))
            in_ch = out_ch
        self.conv_out = _Conv(in_ch, 1, 1, True, dtype, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _leaky(self.conv0(x))
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = _leaky(getattr(self, f"norm{n}")(h, train=train))
        return self.conv_out(h)
