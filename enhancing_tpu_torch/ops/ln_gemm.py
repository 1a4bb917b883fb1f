"""Fused LayerNorm -> GEMM (+bias, +activation) and a standalone LayerNorm.

Counterpart of ``enhancing_tpu/ops/ln_gemm.py``. ``fused_ln_gemm`` computes
``act(LN(x) @ W^T + b)`` without the normalised activation ever reaching
device memory (CUDA kernel ``csrc/ln_gemm.cu``); ``fused_layernorm`` is a
single-pass LayerNorm (``csrc/layernorm.cu``). Both copy the JAX package's
numerics: eps 1e-5, fp32 statistics with the fast variance
``max(E[x^2] - mean^2, 0)``, fp32 affine, the normalised row rounded to the
compute dtype before the product, fp32 accumulation, fp32 bias and
activation, one rounding at the end.

On CUDA each entry point is a ``torch.autograd.Function``: the forward is
the kernel on detached inputs, and the backward is autograd of the plain
version recomputed from the saved inputs, as the JAX package's
``_ln_gemm_bwd`` and ``_layernorm_bwd`` take the VJP of their XLA twins
(``enhancing_tpu/ops/ln_gemm.py:174-181, 444``). On the CPU the plain
version runs and autograd differentiates it directly.

``fused_ln_shift_gemm`` (``csrc/ln_shift_gemm.cu``) is the decode step's
opt-in LN -> token shift -> GEMM, returning LN(x) as the next token's shift
state; inference only.

Weights use torch's Linear layout, ``w: (n, d)``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

ACTIVATIONS = {None: 0, "none": 0, "tanh": 1, "sqrelu": 2, "gelu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {**_DTYPES, torch.int8: 2}
X_DTYPES = tuple(_DTYPES)


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


def _plain_vjp(plain, inputs, grad_out):
    """Gradients of ``plain(*inputs)`` against ``grad_out``, recomputed
    with autograd; None where an input is None or needs no gradient."""
    leaves = [None if t is None else t.detach().requires_grad_(need)
              for t, need in inputs]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = plain(*leaves)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


class _LnGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, activation, eps):
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.activation, ctx.eps = activation, eps
        return ln_gemm_kernel(x, gamma, beta, w, b, activation, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w, b = ctx.saved_tensors
        grads = _plain_vjp(
            lambda *t: ln_gemm_plain(*t, ctx.activation, ctx.eps),
            zip((x, gamma, beta, w, b), ctx.needs_input_grad[:5]), g)
        return (*grads, None, None)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return layernorm_kernel(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        grads = _plain_vjp(lambda *t: layernorm(*t, ctx.eps),
                           zip((x, gamma, beta), ctx.needs_input_grad[:3]),
                           g)
        return (*grads, None)


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
    if use_kernel(x2, gamma, beta, w, b, op="ln_gemm"):
        out = _LnGemm.apply(x2.contiguous(), gamma.float().contiguous(),
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
    if use_kernel(x2, gamma, beta, op="layernorm"):
        out = _LayerNorm.apply(x2.contiguous(), gamma.float().contiguous(),
                               beta.float().contiguous(), eps)
    else:
        out = layernorm(x2, gamma, beta, eps)
    return out.reshape(*batch_shape, x.shape[-1])


def check_vec(name: str, what: str, t, n: int, dtypes=(torch.float32,)):
    """Raise unless ``t`` is None or an (n,) vector of one of ``dtypes``."""
    if t is not None and (t.shape != (n,) or t.dtype not in dtypes):
        raise ValueError(f"{name}: {what} must be ({n},) of "
                         f"{[str(d) for d in dtypes]}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def bias_code(b) -> int:
    return 0 if b is None else DTYPE_CODES[b.dtype]


# -- the decode step's LN -> token shift -> GEMM ------------------------------


def ln_shift_mix(x, gamma, beta, tm, prev, eps=1e-5):
    """(the GEMM's input, LN(x)): LN(x) in x's dtype, then with ``tm`` the
    token shift ``xn * tm + prev * (1 - tm)`` in x's dtype."""
    xn = layernorm(x, gamma, beta, eps)
    if tm is None:
        return xn, xn
    t = tm.to(x.dtype)
    return xn * t + prev.to(x.dtype) * (1.0 - t), xn


def ln_kernel_checks(name, x, gamma, beta, tm, prev, n, b) -> None:
    """Checks of the LN-prologue kernels (int8 and bf16 weights)."""
    m, d = x.shape
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")
    if d % 16:
        raise ValueError(f"{name} kernel needs d % 16 == 0, got d={d}")
    for what, t in (("gamma", gamma), ("beta", beta), ("tm", tm)):
        check_vec(name, what, t, d)
    if (tm is None) != (prev is None):
        raise ValueError(f"{name}: tm and prev go together")
    if prev is not None and (prev.shape != (m, d)
                             or prev.dtype not in X_DTYPES):
        raise ValueError(f"{name}: prev must be fp32 or bf16 ({m}, {d})")
    check_vec(name, "bias", b, n, X_DTYPES)


def ln_operands(x, gamma, beta, tm, prev):
    """2-D contiguous operands of the LN-prologue entry points."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    tm1 = None if tm is None else tm.reshape(-1).float().contiguous()
    p2 = None if tm is None else prev.reshape(-1, d).contiguous()
    return x2, gamma.float().contiguous(), beta.float().contiguous(), tm1, p2


def ln_shift_gemm_plain(x, gamma, beta, tm, prev, w, b=None, activation=None,
                        eps=1e-5):
    """Plain version of the LN -> shift -> GEMM kernel on 2-D operands: w
    in x's dtype, fp32 products and sums, fp32 bias and activation."""
    mixed, xn = ln_shift_mix(x, gamma, beta, tm, prev, eps)
    h = mixed.float() @ w.to(x.dtype).float().t()
    if b is not None:
        h = h + b.float()
    return _act(h, activation).to(x.dtype), xn


def ln_shift_gemm_kernel(x, gamma, beta, tm, prev, w, b=None,
                         activation=None, eps=1e-5):
    """Launch ``csrc/ln_shift_gemm.cu``: x (m, d) fp32 or bf16; fp32
    gamma, beta, tm (d,) (tm None: no shift); prev (m, d) fp32 or bf16;
    w (n, d) bf16 (any x) or fp32 (fp32 x); b (n,) fp32 or bf16."""
    m, d = x.shape
    n = w.shape[0]
    ln_kernel_checks("ln_shift_gemm", x, gamma, beta, tm, prev, n, b)
    if w.shape != (n, d) or not (
            w.dtype == torch.bfloat16
            or (w.dtype == torch.float32 and x.dtype == torch.float32)):
        raise ValueError(f"ln_shift_gemm kernel takes a bf16 (n, {d}) "
                         f"weight, or an fp32 one under fp32 x; got "
                         f"{tuple(w.shape)} {w.dtype} under {x.dtype}")
    check_kernel_args("ln_shift_gemm", x, gamma, beta, tm, prev, w, b)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xn = torch.empty_like(x)
    ws = torch.empty(8 * d, dtype=torch.float32, device=x.device)
    cuda_lib.call("etk_ln_shift_gemm", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), None if tm is None else tm.data_ptr(),
                  None if prev is None else prev.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(), out.data_ptr(),
                  xn.data_ptr(), ws.data_ptr(), m, d, n,
                  ACTIVATIONS[activation], eps,
                  0 if prev is None else DTYPE_CODES[prev.dtype],
                  bias_code(b), DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
                  cuda_lib.stream())
    LAUNCHES["ln_shift_gemm"] += 1
    return out, xn


def fused_ln_shift_gemm(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, tm: torch.Tensor | None,
                        prev: torch.Tensor | None, w: torch.Tensor,
                        b: torch.Tensor | None = None, *,
                        activation: str | None = None, eps: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(act((LN(x) * tm + prev * (1 - tm)) @ w^T + b), LN(x)) in one kernel.

    x: (..., d); gamma, beta, tm: (d,) (tm None skips the shift and prev);
    prev: (..., d), the previous token's LN output; w: (n, d), used in x's
    dtype; b: (n,) or None. Returns ((..., n), (..., d)) in x's dtype. The
    decode step's opt-in fusion (ENHANCING_TPU_DECODE_LNFUSE): inference
    only, so a CUDA launch under autograd raises."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape, n = x.shape[:-1], w.shape[0]
    x2, g, bt, tm1, p2 = ln_operands(x, gamma, beta, tm, prev)
    if use_kernel(x2, g, bt, tm1, p2, w, b, op="ln_shift_gemm"):
        # a bf16 w is widened exactly in the kernel; only fp32 under bf16
        # x needs the cast the JAX wrapper makes
        if w.dtype == torch.float32 and x.dtype == torch.bfloat16:
            w = w.to(x.dtype)
        out, xn = ln_shift_gemm_kernel(
            x2, g, bt, tm1, p2, w.contiguous(),
            None if b is None else b.contiguous(), activation, eps)
    else:
        out, xn = ln_shift_gemm_plain(x2, g, bt, tm1, p2, w, b, activation,
                                      eps)
    return out.reshape(*batch_shape, n), xn.reshape(x.shape)
