"""Fused LayerNorm -> GEMM (+bias, +activation) and a standalone LayerNorm.

Counterpart of ``enhancing_tpu/ops/ln_gemm.py``. ``fused_ln_gemm`` computes
``act(LN(x) @ W^T + b)`` without the normalised activation ever reaching
device memory: CUDA kernels ``csrc/ln_gemm.cu`` (bf16) and
``csrc/ln_gemm_f32.cu`` (fp32 x, on exact bf16 pieces), and for fp32 x of a
few decode rows ``csrc/ln_shift_gemm.cu`` without the shift
(:func:`ln_gemm_route`). ``fused_layernorm`` is a single-pass LayerNorm
(``csrc/layernorm.cu``). Both copy the JAX package's numerics: eps 1e-5,
fp32 statistics with the fast variance ``max(E[x^2] - mean^2, 0)``, fp32
affine, the normalised row rounded to the compute dtype before the
product, fp32 accumulation, fp32 bias and activation, one rounding at the
end.

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
from .common import (LAUNCHES, LN_GEMM_ROUTES, cdiv, check_kernel_args,
                     use_kernel)

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


# the bf16 kernel's tiles (csrc/ln_gemm.cu): 128 rows (two 64-row wgmma
# warpgroups) by 256 or 128 columns, 64-wide k slices
LN_GEMM_TILE_M, LN_GEMM_WIDE_N, LN_GEMM_TILE_K = 128, 256, 64
LN_GEMM_SMEM_LIMIT = 232448 - 2048


def ln_gemm_plan(m: int, n: int, sms: int = 132) -> dict:
    """The bf16 kernel's launch for an (m, d) x (n, d) product on a card of
    ``sms`` SMs, as ``csrc/ln_gemm.cu`` makes it (the C entry
    ``etk_ln_gemm_plan`` returns the same numbers): 256-wide tiles unless
    they would leave SMs idle, then 128-wide; beside a 64 x tile_n bf16
    output staging per consumer warpgroup, as many TMA ring stages (an x
    tile and a W tile each) as shared memory holds, at most 8, and 1 KB
    of alignment slack; one persistent block an SM, at most one a tile."""
    rows = -(-m // LN_GEMM_TILE_M)
    wide = LN_GEMM_WIDE_N
    bn = wide if rows * -(-n // wide) >= sms else 128
    stage = (LN_GEMM_TILE_M + bn) * LN_GEMM_TILE_K * 2
    staging = 2 * 64 * bn * 2
    stages = min(8, (LN_GEMM_SMEM_LIMIT - staging) // stage)
    return dict(tile_m=LN_GEMM_TILE_M, tile_n=bn, stages=stages,
                smem=stages * stage + staging + 1024,
                grid=min(rows * -(-n // bn), sms))


# csrc/ln_gemm_f32.cu: 128 x 128 tiles (two fp32 accumulators of 64 x 128
# a consumer thread), 32-wide k slices of fp32 x (16 KB) and of each W
# piece (8 KB) a ring stage, at most 8 stages
LN_GEMM_F32_TILE, LN_GEMM_F32_K, LN_GEMM_F32_MAX_STAGES = 128, 32, 8


def ln_gemm_f32_plan(m: int, d: int, n: int, w_pieces: int = 3,
                     sms: int = 132) -> dict:
    """The fp32 kernel's launch for an (m, d) x (n, d) product with
    ``w_pieces`` bf16 pieces of W (3: fp32 W, split once a call; 1: bf16 W,
    read as stored) on a card of ``sms`` SMs, as ``csrc/ln_gemm_f32.cu``
    makes it (the C entry ``etk_ln_gemm_f32_plan`` returns the same
    numbers): 128 x 128 tiles, 32-wide k slices, as many ring stages as 227
    KB less 1 KB of alignment slack holds (at most 8), one persistent block
    an SM, at most one a tile. Raises ValueError for what it refuses (d %
    16, as the kernel)."""
    if m <= 0 or n <= 0 or d <= 0 or d % 16 or w_pieces not in (1, 3):
        raise ValueError(f"f32 ln_gemm kernel takes m, n > 0, d % 16 == 0 "
                         f"and 1 or 3 W pieces; got m={m}, d={d}, n={n}, "
                         f"w_pieces={w_pieces}")
    t, k = LN_GEMM_F32_TILE, LN_GEMM_F32_K
    stage = t * k * 4 + w_pieces * t * k * 2
    stages = min(LN_GEMM_F32_MAX_STAGES, (LN_GEMM_SMEM_LIMIT - 1024) // stage)
    return dict(tile_m=t, tile_n=t, tile_k=k, stages=stages,
                smem=stages * stage + 1024,
                grid=min(cdiv(m, t) * cdiv(n, t), sms))


# fp32 x of at most this many rows (a decode step's few) goes to
# csrc/ln_shift_gemm.cu, which reads the weights once per 8 rows at the
# memory's rate; more rows, to csrc/ln_gemm_f32.cu's tiles. The crossing,
# measured at the prior's mlp and head (``ab_ln_gemm_f32.py --route``;
# PERF.md): B11's kernel is the faster up to 64 rows with bf16 W, up to 32
# to 48 with fp32 W
LN_GEMM_DECODE_ROWS = 32


def ln_gemm_route(m: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """The kernel an (m, d) x of ``x_dtype`` with an (n, d) weight of
    ``w_dtype`` (as :func:`fused_ln_gemm` hands it over) runs: ``"decode"``,
    B11's kernel without the shift (``csrc/ln_shift_gemm.cu``), for fp32 x
    of at most ``LN_GEMM_DECODE_ROWS`` rows; ``"f32"``, ``csrc/ln_gemm_f32.cu``,
    for other fp32 x; ``"bf16"``, ``csrc/ln_gemm.cu``. A bf16 weight under
    fp32 x is used as stored on both fp32 routes."""
    if x_dtype == torch.float32:
        if w_dtype not in _DTYPES:
            raise TypeError(f"ln_gemm kernel takes a bf16 or f32 w under "
                            f"f32 x, got {w_dtype}")
        return "decode" if m <= LN_GEMM_DECODE_ROWS else "f32"
    if x_dtype != torch.bfloat16 or w_dtype != torch.bfloat16:
        raise TypeError(f"ln_gemm kernel takes bf16 w under bf16 x, or f32 "
                        f"x; got {x_dtype} and {w_dtype}")
    return "bf16"


def ln_gemm_kernel(x, gamma, beta, w, b=None, activation=None, eps=1e-5):
    """Launch the LN -> GEMM kernel of :func:`ln_gemm_route` on CUDA tensors
    x (m, d) bf16 or f32, w (n, d) (bf16 under bf16 x; bf16 or f32 under
    f32 x, used as stored), fp32 gamma/beta (d,) and bias (n,). The tiled
    kernels first write each row's mean and rstd into a 2 * m fp32
    workspace (and fp32 W's pieces into a bf16 one); one wrapper call, one
    launch counted, and in ``LN_GEMM_ROUTES`` under its route."""
    m, d = x.shape
    n = w.shape[0]
    route = ln_gemm_route(m, x.dtype, w.dtype)
    if route == "bf16" and (d % 32 or n % 8):
        raise ValueError(f"bf16 ln_gemm kernel needs d % 32 == 0 and "
                         f"n % 8 == 0, got d={d}, n={n}")
    if route != "bf16" and d % 16:
        raise ValueError(f"f32 ln_gemm kernel needs d % 16 == 0, got d={d}")
    if w.shape[1] != d or gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError("ln_gemm: shapes of x, w, gamma, beta disagree")
    if any(t.dtype != torch.float32 for t in (gamma, beta)) or (
            b is not None and (b.dtype != torch.float32 or b.shape != (n,))):
        raise TypeError("ln_gemm kernel takes fp32 gamma, beta and bias")
    check_kernel_args("ln_gemm", x, gamma, beta, w, b)
    if route == "decode":
        out, _ = _ln_shift_gemm_launch(x, gamma, beta, None, None, w, b,
                                       activation, eps, want_xn=False)
        LAUNCHES["ln_gemm"] += 1
        LN_GEMM_ROUTES[route] += 1
        return out
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # the row statistics: m means, then m rstds
    stats = torch.empty(2 * m, dtype=torch.float32, device=x.device)
    if route == "bf16":
        cuda_lib.call("etk_ln_gemm", x.data_ptr(), gamma.data_ptr(),
                      beta.data_ptr(), w.data_ptr(),
                      None if b is None else b.data_ptr(), out.data_ptr(),
                      stats.data_ptr(), m, d, n, ACTIVATIONS[activation],
                      eps, _DTYPES[x.dtype], cuda_lib.stream())
    else:
        # fp32 W's three bf16 pieces, written by the kernel's split pass
        pieces = (torch.empty(3 * n * d, dtype=torch.bfloat16,
                              device=x.device)
                  if w.dtype == torch.float32 else None)
        cuda_lib.call("etk_ln_gemm_f32", x.data_ptr(), gamma.data_ptr(),
                      beta.data_ptr(), w.data_ptr(),
                      None if b is None else b.data_ptr(), out.data_ptr(),
                      stats.data_ptr(),
                      None if pieces is None else pieces.data_ptr(), m, d, n,
                      ACTIVATIONS[activation], eps, _DTYPES[w.dtype],
                      cuda_lib.stream())
    LAUNCHES["ln_gemm"] += 1
    LN_GEMM_ROUTES[route] += 1
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

    x: (..., d); gamma/beta: (d,); w: (n, d), used in ``x.dtype``; b: (n,)
    or None, applied in fp32. CUDA tensors run the kernel, CPU tensors the
    plain version. The kernels read a bf16 w under fp32 x as stored (its
    widening is exact); the plain version widens it, as the JAX wrapper
    does.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel(x2, gamma, beta, w, b, op="ln_gemm"):
        if not (x.dtype == torch.float32 and w.dtype == torch.bfloat16):
            w = w.to(x.dtype)
        out = _LnGemm.apply(x2.contiguous(), gamma.float().contiguous(),
                            beta.float().contiguous(), w.contiguous(),
                            None if b is None else b.float().contiguous(),
                            activation, eps)
    else:
        out = ln_gemm_plain(x2, gamma, beta, w, b, activation, eps)
    return out.reshape(*batch_shape, w.shape[0])


# csrc/layernorm.cu: eight consumer warps (a row each), tiles of at least
# 8 KB (up to 8 rows a warp), a ring of at most 96 KB and 4 stages, three
# blocks an SM where shared memory holds them
LN_WARPS, LN_TILE_TARGET, LN_RING_BUDGET, LN_MAX_STAGES = 8, 8192, 98304, 4
LN_BLOCKS_PER_SM, LN_MAX_D = 3, 2048


def layernorm_plan(m: int, d: int, itemsize: int, sms: int = 132) -> dict:
    """The LayerNorm kernel's launch for an (m, d) input of ``itemsize``-
    byte elements on a card of ``sms`` SMs, as ``csrc/layernorm.cu`` makes
    it (the C entry ``etk_layernorm_plan`` returns the same numbers): rows
    a tile, ring stages, dynamic shared memory (the ring, fp32 gamma and
    beta) and a persistent grid. Raises ValueError for a shape the kernel
    refuses."""
    if itemsize not in (2, 4) or m <= 0 or d <= 0 or d > LN_MAX_D \
            or d % (16 // itemsize):
        raise ValueError(f"layernorm kernel needs 0 < d <= {LN_MAX_D}, "
                         f"d % {16 // itemsize} == 0 and m > 0; got "
                         f"m={m}, d={d}, itemsize={itemsize}")
    row_bytes = d * itemsize
    rows = LN_WARPS * min(max(LN_TILE_TARGET // (LN_WARPS * row_bytes), 1), 8)
    tile = rows * row_bytes
    stages = min(max(LN_RING_BUDGET // tile, 2), LN_MAX_STAGES)
    smem = stages * tile + 2 * d * 4
    per_sm = min(max(233472 // (smem + 2048), 1), LN_BLOCKS_PER_SM)
    return dict(rows=rows, stages=stages, smem=smem,
                grid=min(cdiv(m, rows), sms * per_sm))


def layernorm_kernel(x, gamma, beta, eps=1e-5):
    """Launch ``csrc/layernorm.cu`` on a CUDA (m, d) bf16/f32 tensor whose
    data and output start 16-byte aligned (bulk copies, vector stores)."""
    m, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"layernorm kernel takes bf16 or f32, got {x.dtype}")
    layernorm_plan(m, d, x.element_size())
    if x.data_ptr() % 16:
        raise ValueError("layernorm kernel needs x 16-byte aligned")
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


def ln_shift_gemm_plan(m: int, d: int, n: int, x_dtype: torch.dtype,
                       w_dtype: torch.dtype, sms: int = 132) -> dict:
    """The launch of ``csrc/ln_shift_gemm.cu`` (``csrc/int8_gemm.cuh``'s
    plan, ``ops.int8.int8_gemm_plan``, on 2- or 4-byte weights; the C entry
    ``etk_ln_shift_gemm_plan`` returns the same numbers) for an (m, d) x of
    ``x_dtype`` and an (n, d) weight of ``w_dtype``: a bf16 weight under
    fp32 or bf16 x, an fp32 one under fp32 x. Raises ValueError for what
    the kernel refuses."""
    from .int8 import int8_gemm_plan
    if x_dtype not in _DTYPES or w_dtype not in _DTYPES or (
            x_dtype == torch.bfloat16 and w_dtype == torch.float32):
        raise ValueError(f"ln_shift_gemm kernel takes a bf16 weight, or an "
                         f"fp32 one under fp32 x; got {w_dtype} under "
                         f"{x_dtype}")
    return int8_gemm_plan(m, d, n, sms, 3 if x_dtype == torch.float32 else 1,
                          2 if w_dtype == torch.bfloat16 else 4)


def _ln_shift_gemm_launch(x, gamma, beta, tm, prev, w, b, activation, eps,
                          want_xn=True):
    """Launch ``csrc/ln_shift_gemm.cu`` on checked operands (out, and LN(x)
    if ``want_xn``, else None), its split partials and counts in scratch
    kinds of their own (``ops.int8.LN_SHIFT_KINDS``)."""
    from .int8 import LN_SHIFT_KINDS, gemm_scratch
    m, d = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xn = torch.empty_like(x) if want_xn else None
    stream = cuda_lib.stream()
    scratch = gemm_scratch(x, n, stream, w.element_size(), LN_SHIFT_KINDS)
    cuda_lib.call("etk_ln_shift_gemm", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), None if tm is None else tm.data_ptr(),
                  None if prev is None else prev.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(), out.data_ptr(),
                  None if xn is None else xn.data_ptr(), *scratch, m, d, n,
                  ACTIVATIONS[activation], eps,
                  0 if prev is None else DTYPE_CODES[prev.dtype],
                  bias_code(b), DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
                  stream)
    return out, xn


def ln_shift_gemm_kernel(x, gamma, beta, tm, prev, w, b=None,
                         activation=None, eps=1e-5):
    """Launch ``csrc/ln_shift_gemm.cu``: x (m, d) fp32 or bf16; fp32
    gamma, beta, tm (d,) (tm None: no shift); prev (m, d) fp32 or bf16;
    w (n, d) bf16 (any x) or fp32 (fp32 x); b (n,) fp32 or bf16. One
    launch (:func:`ln_shift_gemm_plan`)."""
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
    out, xn = _ln_shift_gemm_launch(x, gamma, beta, tm, prev, w, b,
                                    activation, eps)
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
