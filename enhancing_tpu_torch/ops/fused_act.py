"""Fused bias + leaky ReLU with sqrt(2) gain (StyleGAN's FusedLeakyReLU).

Counterpart of ``enhancing_tpu/ops/fused_act.py``:
``y = scale * leaky_relu(x + bias, slope)``, slope 0.2 and scale sqrt(2),
with the bias over the last (channel) axis of NHWC activations.

On CUDA the forward is the kernel ``csrc/fused_act.cu`` inside a
``torch.autograd.Function`` whose backward reads the sign of the saved
output, as ``_fused_op_bwd`` does (``:91-102``): for slope > 0, y >= 0
exactly where x + bias >= 0, so only y is kept. The backward is plain
PyTorch, as it is plain XLA in the JAX package. Given CPU tensors, the
Function runs the plain forward (the tests hold its backward against
JAX's there).
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

SLOPE = 0.2
SCALE = math.sqrt(2.0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _in_dtype(v: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python scalar as JAX's weak typing meets an array of ``dtype``:
    converted to that dtype first (0.2 is 0.2001953125 in bf16)."""
    return torch.tensor(v, dtype=dtype)


def fused_act_plain(x: torch.Tensor, bias: torch.Tensor, slope: float = SLOPE,
                    scale: float = SCALE) -> torch.Tensor:
    """The bias, slope and scale are cast to x's dtype and every step
    rounds there."""
    t = x + bias.to(x.dtype)
    # 0-dim CPU tensors combine with tensors on any device, uncopied
    slope_t, scale_t = (_in_dtype(v, x.dtype) for v in (slope, scale))
    return scale_t * torch.where(t >= 0, t, slope_t * t)


def fused_act_kernel(x: torch.Tensor, bias: torch.Tensor, slope: float = SLOPE,
                     scale: float = SCALE) -> torch.Tensor:
    """Launch ``csrc/fused_act.cu`` on a CUDA f32/bf16 x (..., C) and an
    f32 bias (C,)."""
    c = x.shape[-1]
    if x.dtype not in _DTYPES or bias.dtype != torch.float32:
        raise TypeError(f"fused_act kernel takes f32 or bf16 x and an f32 "
                        f"bias, got {x.dtype} and {bias.dtype}")
    vec = 4 if x.dtype == torch.float32 else 8
    if c % vec or bias.shape != (c,) or x.numel() == 0:
        raise ValueError(f"fused_act kernel needs C % {vec} == 0 and a bias "
                         f"of (C,), got x {tuple(x.shape)} and bias "
                         f"{tuple(bias.shape)}")
    check_kernel_args("fused_act", x, bias)
    y = torch.empty_like(x)
    cuda_lib.call("etk_fused_act", x.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), x.numel() // c, c,
                  float(_in_dtype(slope, x.dtype)),
                  float(_in_dtype(scale, x.dtype)), _DTYPES[x.dtype],
                  cuda_lib.stream())
    LAUNCHES["fused_act"] += 1
    return y


class FusedLeakyReLU(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward; backward from sign(y)."""

    @staticmethod
    def forward(ctx, x, bias, slope, scale):
        if x.is_cuda:
            y = fused_act_kernel(x, bias, slope, scale)
        else:
            y = fused_act_plain(x, bias, slope, scale)
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale = slope, scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        gain = torch.where(y >= 0, ctx.scale, ctx.scale * ctx.slope)
        dt = gain.to(g.dtype) * g
        db = torch.sum(dt, dim=tuple(range(dt.dim() - 1))).float()
        return dt, db, None, None


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor, slope: float = SLOPE,
                     scale: float = SCALE) -> torch.Tensor:
    """y = scale * leaky_relu(x + bias) with bias over the last axis.

    CUDA tensors run the kernel through :class:`FusedLeakyReLU`; CPU
    tensors, and CUDA tensors inside ``force_plain_ops``, the plain
    version, which autograd differentiates to any order."""
    if use_kernel(x, bias, op="fused_act"):
        return FusedLeakyReLU.apply(x.contiguous(), bias.float().contiguous(),
                                    float(slope), float(scale))
    return fused_act_plain(x, bias, slope, scale)
