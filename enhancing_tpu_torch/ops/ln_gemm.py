"""Fused LayerNorm -> GEMM (+bias, +activation) and a standalone LayerNorm.

Counterpart of ``enhancing_tpu/ops/ln_gemm.py``. ``fused_ln_gemm`` computes
``act(LN(x) @ W^T + b)`` without the normalised activation ever reaching
device memory (CUDA kernel ``csrc/ln_gemm.cu``); ``fused_layernorm`` is a
single-pass LayerNorm (``csrc/layernorm.cu``). Both copy the JAX package's
numerics: eps 1e-5, fp32 statistics with the fast variance
``max(E[x^2] - mean^2, 0)``, fp32 affine, the normalised row rounded to the
compute dtype before the product, fp32 accumulation, fp32 bias and
activation, one rounding at the end.

Weights use torch's Linear layout, ``w: (n, d)``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

ACTIVATIONS = {None: 0, "none": 0, "tanh": 1, "sqrelu": 2, "gelu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _act(h: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation in (None, "none"):
        return h
    if activation == "tanh":
        return torch.tanh(h)
    if activation == "sqrelu":
        return torch.square(torch.relu(h))
    if activation == "gelu":
        return torch.nn.functional.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm with flax's numerics: fp32 fast-variance statistics,
    fp32 affine, result cast back to ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (x32 - mean) * (torch.rsqrt(var + eps) * gamma.float()) + beta.float()
    return y.to(x.dtype)


def ln_gemm_plain(x, gamma, beta, w, b=None, activation=None, eps=1e-5):
    """Plain version of the LN -> GEMM kernel, on the same 2-D operands."""
    xn = layernorm(x, gamma, beta, eps)
    # bf16 x bf16 products are exact in fp32, so this is an fp32-accumulated
    # product of the rounded operands, as the kernel computes it
    h = xn.float() @ w.to(x.dtype).float().t()
    if b is not None:
        h = h + b.float()
    return _act(h, activation).to(x.dtype)


def ln_gemm_kernel(x, gamma, beta, w, b=None, activation=None, eps=1e-5):
    """Launch ``csrc/ln_gemm.cu`` on CUDA tensors x (m, d), w (n, d) of one
    dtype (bf16 or f32), fp32 gamma/beta (d,) and bias (n,)."""
    m, d = x.shape
    n = w.shape[0]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"ln_gemm kernel takes bf16 or f32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if x.dtype == torch.bfloat16 and (d % 32 or n % 8):
        raise ValueError(f"bf16 ln_gemm kernel needs d % 32 == 0 and "
                         f"n % 8 == 0, got d={d}, n={n}")
    if x.dtype == torch.float32 and d % 16:
        raise ValueError(f"f32 ln_gemm kernel needs d % 16 == 0, got d={d}")
    if w.shape[1] != d or gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError("ln_gemm: shapes of x, w, gamma, beta disagree")
    if any(t.dtype != torch.float32 for t in (gamma, beta)) or (
            b is not None and (b.dtype != torch.float32 or b.shape != (n,))):
        raise TypeError("ln_gemm kernel takes fp32 gamma, beta and bias")
    check_kernel_args("ln_gemm", x, gamma, beta, w, b)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    cuda_lib.call("etk_ln_gemm", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(),
                  out.data_ptr(), m, d, n, ACTIVATIONS[activation], eps,
                  _DTYPES[x.dtype], cuda_lib.stream())
    LAUNCHES["ln_gemm"] += 1
    return out


def fused_ln_gemm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor | None = None, *,
                  activation: str | None = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """y = act(LayerNorm(x; gamma, beta) @ w^T + b).

    x: (..., d); gamma/beta: (d,); w: (n, d), cast to ``x.dtype``; b: (n,)
    or None, applied in fp32. CUDA tensors run the kernel, CPU tensors the
    plain version.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    w = w.to(x.dtype)
    if use_kernel(x2, gamma, beta, w, b):
        out = ln_gemm_kernel(x2.contiguous(), gamma.float().contiguous(),
                             beta.float().contiguous(), w.contiguous(),
                             None if b is None else b.float().contiguous(),
                             activation, eps)
    else:
        out = ln_gemm_plain(x2, gamma, beta, w, b, activation, eps)
    return out.reshape(*batch_shape, w.shape[0])


def layernorm_kernel(x, gamma, beta, eps=1e-5):
    """Launch ``csrc/layernorm.cu`` on a CUDA (m, d) bf16/f32 tensor."""
    m, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes bf16 or f32, got {x.dtype}")
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if d % vec or d > 2048:
        raise ValueError(f"layernorm kernel needs d % {vec} == 0 and "
                         f"d <= 2048, got d={d}")
    if gamma.shape != (d,) or beta.shape != (d,) or any(
            t.dtype != torch.float32 for t in (gamma, beta)):
        raise ValueError("layernorm kernel takes fp32 gamma and beta of (d,)")
    check_kernel_args("layernorm", x, gamma, beta)
    out = torch.empty_like(x)
    cuda_lib.call("etk_layernorm", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), m, d, eps,
                  _DTYPES[x.dtype], cuda_lib.stream())
    LAUNCHES["layernorm"] += 1
    return out


def fused_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x; gamma, beta) over the last axis in one pass."""
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel(x2, gamma, beta):
        out = layernorm_kernel(x2.contiguous(), gamma.float().contiguous(),
                               beta.float().contiguous(), eps)
    else:
        out = layernorm(x2, gamma, beta, eps)
    return out.reshape(*batch_shape, x.shape[-1])
