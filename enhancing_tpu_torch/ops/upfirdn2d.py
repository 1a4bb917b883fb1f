"""upfirdn2d: upsample, FIR filter, downsample (the StyleGAN blur), NHWC.

Counterpart of ``enhancing_tpu/ops/upfirdn2d.py``. Semantics: zero-insert
upsample by ``up``, pad by (pad0, pad1) per spatial axis (negative pads
crop), convolve (kernel flipped) with the 2-D FIR kernel, keep every
``down``-th pixel.

- The plain version, for any up/down/pad, is one depthwise ``F.conv2d``
  with the flipped kernel, as ``_upfirdn2d_xla`` is one grouped
  convolution (``:44-67``).
- ``up = down = 1`` (the discriminator's blur) on CUDA runs the kernel
  ``csrc/fir.cu`` inside a ``torch.autograd.Function`` whose backward is
  autograd of the plain version, as ``_fir_fused_bwd`` is (``:139-144``).
  The JAX package sends only panels of 512 KB or less to Pallas, a VMEM
  budget of the TPU; here every such blur takes the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 8


def _norm_pad(pad) -> Tuple[int, int, int, int]:
    """(padx0, padx1, pady0, pady1) from an int, a pair or a 4-tuple."""
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    if len(pad) == 2:
        return (pad[0], pad[1], pad[0], pad[1])
    return tuple(pad)


def upfirdn2d_plain(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
                    down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """x: (B, H, W, C); kernel: (kh, kw). Returns (B, H', W', C) in x's
    dtype (the kernel is cast to it, as the JAX twin casts)."""
    px0, px1, py0, py1 = _norm_pad(pad)
    b, h, w, c = x.shape
    t = x.permute(0, 3, 1, 2)
    if up > 1:
        z = t.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = t
        t = z
    t = F.pad(t, (px0, px1, py0, py1))
    weight = torch.flip(kernel.to(device=x.device, dtype=x.dtype), (0, 1))
    weight = weight[None, None].expand(c, 1, *kernel.shape)
    out = F.conv2d(t, weight, stride=down, groups=c)
    return out.permute(0, 2, 3, 1)


def fir_kernel(x: torch.Tensor, taps: Sequence[Sequence[float]],
               pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Launch ``csrc/fir.cu`` on a CUDA (B, H, W, C) f32/bf16 tensor;
    ``taps`` is the pre-flipped kernel, ``pad`` (px0, px1, py0, py1)."""
    b, h, w, c = x.shape
    kh, kw = len(taps), len(taps[0])
    px0, px1, py0, py1 = pad
    if x.dtype not in _DTYPES:
        raise TypeError(f"fir kernel takes f32 or bf16, got {x.dtype}")
    vec = 4 if x.dtype == torch.float32 else 8
    ho, wo = h + py0 + py1 - kh + 1, w + px0 + px1 - kw + 1
    if c % vec or not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS) \
            or ho <= 0 or wo <= 0:
        raise ValueError(f"fir kernel needs C % {vec} == 0, taps up to "
                         f"{MAX_TAPS} x {MAX_TAPS} and a non-empty output; "
                         f"got x {tuple(x.shape)}, taps {kh} x {kw}, pad "
                         f"{pad}")
    check_kernel_args("fir", x)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    flat = (ctypes.c_float * (kh * kw))(*(float(v) for row in taps
                                          for v in row))
    cuda_lib.call("etk_fir", x.data_ptr(), out.data_ptr(), flat, b, h, w, c,
                  kh, kw, py0, py1, px0, px1, _DTYPES[x.dtype],
                  cuda_lib.stream())
    LAUNCHES["fir"] += 1
    return out


class _FIR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, pad):
        ctx.save_for_backward(x, kernel)
        ctx.pad = pad
        taps = torch.flip(kernel, (0, 1)).tolist()
        return fir_kernel(x, taps, pad)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            out = upfirdn2d_plain(x, kernel, 1, 1, ctx.pad)
            (dx,) = torch.autograd.grad(out, x, g)
        return dx, None, None


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Upsample-FIR-downsample on NHWC images; ``kernel`` is a concrete
    2-D FIR kernel. CUDA tensors with up = down = 1 run the kernel, every
    other call the plain version."""
    pad4 = _norm_pad(pad)
    if up == 1 and down == 1 and use_kernel(x, op="fir"):
        return _FIR.apply(x.contiguous(), kernel.detach().float().cpu(), pad4)
    return upfirdn2d_plain(x, kernel, up, down, pad4)


def make_blur_kernel(taps, upsample_factor: int = 1) -> torch.Tensor:
    """1-D taps -> normalised 2-D separable blur kernel (f32, on the CPU);
    the upsample_factor**2 gain compensates zero-stuffed upsampling."""
    k = torch.as_tensor(taps, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    k = k / torch.sum(k)
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    return k
