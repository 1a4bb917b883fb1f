"""upfirdn2d: upsample, FIR filter, downsample (the StyleGAN blur), NHWC.

Counterpart of ``enhancing_tpu/ops/upfirdn2d.py``. Semantics: zero-insert
upsample by ``up``, pad by (pad0, pad1) per spatial axis (negative pads
crop), convolve (kernel flipped) with the 2-D FIR kernel, keep every
``down``-th pixel.

- The plain version, for any up/down/pad, is one depthwise ``F.conv2d``
  with the flipped kernel, as ``_upfirdn2d_xla`` is one grouped
  convolution (``:44-67``).
- ``up = down = 1`` (the discriminator's blur) on CUDA runs the kernel
  ``csrc/fir.cu`` inside a ``torch.autograd.Function``. Its backward is
  the VJP of the same blur, as ``_fir_fused_bwd`` takes it (``:139-144``):
  for up = down = 1 that VJP is itself such a blur of the output's
  gradient, with the taps unflipped and the pads mirrored
  (:func:`fir_vjp_pad`), so the backward launches the same kernel,
  counted as ``fir_vjp``. It is first-order only: R1's second derivative
  runs on the plain version (``common.force_plain_ops``). The JAX
  package sends only panels of 512 KB or less to Pallas, a VMEM budget
  of the TPU; here every such blur takes the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import cuda_lib
from .common import LAUNCHES, cdiv, check_kernel_args, use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 8
# csrc/fir.cu: channel vectors a column of a block, computing threads,
# ring stages, the least rows of a row chunk
FIR_VECS, FIR_CONSUMERS, FIR_STAGES, FIR_CHUNK_ROWS = 32, 256, 4, 32


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


def fir_vjp_pad(pad: Tuple[int, int, int, int], kh: int,
                kw: int) -> Tuple[int, int, int, int]:
    """The pads of the blur that is the VJP of an up = down = 1 blur with
    ``pad`` (px0, px1, py0, py1) and a (kh, kw) kernel: filtering the
    output's gradient with the unflipped taps at these pads gives x's
    gradient, of x's shape (ho + (kh - 1 - py0) + (kh - 1 - py1) - kh + 1
    = H)."""
    px0, px1, py0, py1 = pad
    return (kw - 1 - px0, kw - 1 - px1, kh - 1 - py0, kh - 1 - py1)


def fir_plan(b: int, c: int, ho: int, wo: int, kw: int, dtype: torch.dtype,
             sms: int, per_sm: int) -> dict:
    """``etk_fir_plan``'s split of a (b, ho, wo, c) blur output into blocks
    on a card of ``sms`` SMs where ``per_sm`` blocks fit an SM at once (the
    occupancy query's answer for the kernel): channel vectors a column (a
    16-byte vector holds 4 fp32 or 8 bf16), output columns a strip (a TMA
    box is at most 256 columns wide, halo included), rows a chunk (chunks
    of at least 32 rows, as many as the blocks' one wave leaves room for),
    channel groups, computing threads, the box's bytes, the dynamic shared
    memory and ``per_sm``."""
    vecs = c // (4 if dtype == torch.float32 else 8)
    vb = min(vecs, FIR_VECS)
    cgroups = cdiv(vecs, vb)
    most = min(FIR_CONSUMERS // vb, 256 - (kw - 1))
    strips = cdiv(wo, most)
    sw = cdiv(wo, strips)
    blocks = strips * cgroups * b
    chunks = max(1, min(per_sm * sms // blocks, ho // FIR_CHUNK_ROWS))
    rows = cdiv(ho, chunks)
    box = (sw + kw - 1) * vb * 16
    return dict(vecs=vb, strip=sw, strips=strips, rows=rows,
                chunks=cdiv(ho, rows), cgroups=cgroups,
                consumers=cdiv(sw * vb, 32) * 32, box=box,
                smem=FIR_STAGES * cdiv(box, 128) * 128 + 128, per_sm=per_sm)


def fir_kernel(x: torch.Tensor, taps: Sequence[Sequence[float]],
               pad: Tuple[int, int, int, int],
               counter: str = "fir") -> torch.Tensor:
    """Launch ``csrc/fir.cu`` on a CUDA (B, H, W, C) f32/bf16 tensor;
    ``taps`` is the pre-flipped kernel, ``pad`` (px0, px1, py0, py1). The
    launch is counted in ``LAUNCHES[counter]``: ``fir``, or ``fir_vjp``
    for the backward's."""
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
    flat = _TAP_ARRAYS.get(taps) if isinstance(taps, tuple) else None
    if flat is None:
        flat = (ctypes.c_float * (kh * kw))(*(float(v) for row in taps
                                              for v in row))
        if isinstance(taps, tuple):
            _TAP_ARRAYS[taps] = flat
    cuda_lib.call("etk_fir", x.data_ptr(), out.data_ptr(), flat, b, h, w, c,
                  kh, kw, py0, py1, px0, px1, _DTYPES[x.dtype],
                  cuda_lib.stream())
    LAUNCHES[counter] += 1
    return out


# The host's work of a launch, kept: the taps of each kernel a caller has
# passed, flipped and as given (nested tuples, by the kernel's values), and
# the fp32 array handed to the C entry for each tuple of taps. The
# discriminator passes one 4 x 4 blur 72 times a training step.
_TAPS: dict = {}
_TAP_ARRAYS: dict = {}


def _taps(kernel: torch.Tensor) -> tuple:
    """(the pre-flipped taps, the taps as given) of a 2-D kernel."""
    k = kernel.detach().float().cpu()
    key = (tuple(k.shape), k.numpy().tobytes())
    taps = _TAPS.get(key)
    if taps is None:
        taps = _TAPS[key] = tuple(
            tuple(map(tuple, t.tolist())) for t in (torch.flip(k, (0, 1)), k))
    return taps


class _FIR(torch.autograd.Function):
    """The blur on ``csrc/fir.cu``, forward and VJP: ``flipped`` the
    pre-flipped taps, ``taps`` the caller's."""

    @staticmethod
    def forward(ctx, x, flipped, taps, pad):
        ctx.taps, ctx.pad = taps, pad
        return fir_kernel(x, flipped, pad)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        kh, kw = len(ctx.taps), len(ctx.taps[0])
        dx = fir_kernel(g.contiguous(), ctx.taps,
                        fir_vjp_pad(ctx.pad, kh, kw), counter="fir_vjp")
        return dx, None, None, None


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Upsample-FIR-downsample on NHWC images; ``kernel`` is a concrete
    2-D FIR kernel. CUDA tensors with up = down = 1 run the kernel (through
    the autograd function only where a gradient is wanted), every other
    call the plain version."""
    pad4 = _norm_pad(pad)
    if up == 1 and down == 1 and use_kernel(x, op="fir"):
        flipped, taps = _taps(kernel)
        x = x.contiguous()
        if torch.is_grad_enabled() and x.requires_grad:
            return _FIR.apply(x, flipped, taps, pad4)
        return fir_kernel(x, flipped, pad4)
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
