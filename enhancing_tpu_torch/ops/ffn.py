"""Fused position-wise FFN: act(x @ W1^T + b1) @ W2^T + b2 in one kernel.

Counterpart of ``enhancing_tpu/ops/ffn.py``. ``fused_ffn`` keeps the
(tokens, mlp_dim) hidden out of device memory (CUDA kernel
``csrc/ffn.cu``, B16). The plain version computes the kernel's numerics
(``_ffn_kernel``), not ``_ffn_xla``'s: the hidden is an fp32 product plus
the fp32 bias, the activation runs in fp32, the hidden is rounded to the
compute dtype before W2, the W2 products sum in fp32, then + b2 in fp32
and one rounding. In f32 the two are the same function; in bf16
``_ffn_xla`` rounds after each dot and adds the biases in bf16 (the
port's LN -> GEMM copies its kernel likewise, ROADMAP §C).

On CUDA the entry point is a ``torch.autograd.Function``: the forward is
the kernel, the backward autograd of the plain version recomputed from
the saved inputs, as ``_ffn_fused_bwd`` takes the VJP of ``_ffn_xla``.

Weights use torch's Linear layout: ``w1: (h, d)``, ``w2: (d, h)``. The JAX
dispatch limits that exist for VMEM and the 128 lanes (``_MAX_WEIGHT_BYTES``,
``d % 128``, ``_H_CHUNK`` divisibility, ``ffn.py:131-155``) are not
reproduced: the XLA path they fall back to computes the same function in
f32. The kernel takes bf16 x and weights, fp32 biases, d and h multiples
of 64 and d up to 2048 (every stage-1 config: d 64-1280, h 128-5120), and
raises otherwise. ``ffn_plan`` mirrors the kernel's choice of cluster.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel
from .ln_gemm import ACTIVATIONS, _act, _plain_vjp

FFN_ACTIVATIONS = ("tanh", "sqrelu", "gelu")
# the kernel's shapes (csrc/ffn.cu): 128-row blocks in clusters of C (1, 2,
# 4 or 8), each block owning an output slab of DS columns, the hidden
# walked in 64-wide chunks
FFN_CLUSTERS, FFN_SLABS, FFN_CHUNK, FFN_TILE_M = (1, 2, 4, 8), \
    (64, 128, 160, 192, 256), 64, 128
FFN_MAX_STAGES, FFN_SMEM_LIMIT = 8, 232448 - 2048
FFN_MAX_D = max(FFN_CLUSTERS) * max(FFN_SLABS)


def ffn_plan(d: int) -> dict | None:
    """The kernel's cluster for width d, as ``csrc/ffn.cu::ffn_plan`` picks
    it (the C entry ``etk_ffn_plan`` returns the same numbers): C and DS
    with C * DS >= d and the fewest padded columns, then the smallest C;
    two group buffers of C hidden chunks (128 x 64 bf16 each) if four TMA
    ring stages (an x tile and a W1 tile, or a W2 tile) fit beside them,
    else one; then as many stages as shared memory holds, at most 8. None
    where no cluster covers d."""
    best = None
    for c in FFN_CLUSTERS:
        for ds in FFN_SLABS:
            if c * ds >= d and (best is None or c * ds - d < best[0]):
                best = (c * ds - d, c, ds)
    if best is None:
        return None
    _, c, ds = best
    stage = max((FFN_TILE_M + FFN_CHUNK) * 64 * 2, ds * 64 * 2)
    slots = c * FFN_TILE_M * FFN_CHUNK * 2
    buffers = 2 if (FFN_SMEM_LIMIT - 2 * slots) // stage >= 4 else 1
    stages = min(FFN_MAX_STAGES, (FFN_SMEM_LIMIT - buffers * slots) // stage)
    return dict(cluster=c, slab=ds, chunk=FFN_CHUNK, buffers=buffers,
                stages=stages, smem=buffers * slots + stages * stage + 1024)


def ffn_plain(x, w1, b1, w2, b2, activation="tanh"):
    """Plain version of the fused FFN kernel on 2-D x (m, d)."""
    h = x.float() @ w1.to(x.dtype).float().t() + b1.float()
    h = _act(h, activation).to(x.dtype)
    out = h.float() @ w2.to(x.dtype).float().t() + b2.float()
    return out.to(x.dtype)


def ffn_kernel(x, w1, b1, w2, b2, activation="tanh"):
    """Launch ``csrc/ffn.cu`` on CUDA bf16 x (m, d), w1 (h, d), w2 (d, h)
    and fp32 b1 (h,), b2 (d,), all contiguous."""
    m, d = x.shape
    h = w1.shape[0]
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w2)) or any(
            t.dtype != torch.float32 for t in (b1, b2)):
        raise TypeError("ffn kernel takes bf16 x, w1, w2 and fp32 biases "
                        "(fp32 is not ported yet: ROADMAP.md C1)")
    if (w1.shape != (h, d) or w2.shape != (d, h) or b1.shape != (h,)
            or b2.shape != (d,)):
        raise ValueError(f"ffn: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)} and the biases do not fit")
    if d % 64 or h % 64 or d > FFN_MAX_D:
        raise ValueError(f"ffn kernel needs d % 64 == 0, h % 64 == 0 and "
                         f"d <= {FFN_MAX_D}, got d={d}, h={h}")
    if activation not in FFN_ACTIVATIONS:
        raise ValueError(f"ffn activation must be one of {FFN_ACTIVATIONS}")
    check_kernel_args("ffn", x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    cuda_lib.call("etk_ffn", *(t.data_ptr() for t in (x, w1, b1, w2, b2, out)),
                  m, d, h, ACTIVATIONS[activation], cuda_lib.stream())
    LAUNCHES["ffn"] += 1
    return out


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.activation = activation
        return ffn_kernel(x, w1, b1, w2, b2, activation)

    @staticmethod
    def backward(ctx, g):
        grads = _plain_vjp(lambda *t: ffn_plain(*t, ctx.activation),
                           zip(ctx.saved_tensors, ctx.needs_input_grad[:5]),
                           g)
        return (*grads, None)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, *,
              activation: str = "tanh") -> torch.Tensor:
    """y = act(x @ w1^T + b1) @ w2^T + b2 with the hidden kept on chip.

    x: (..., d); w1: (h, d) and w2: (d, h), cast to x's dtype; b1: (h,),
    b2: (d,), applied in fp32. CUDA tensors run the kernel, CPU tensors
    the plain version.
    """
    if activation not in FFN_ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    if use_kernel(x2, w1, b1, w2, b2, op="ffn"):
        out = _FusedFFN.apply(x2.contiguous(), w1.contiguous(),
                              b1.float().contiguous(), w2.contiguous(),
                              b2.float().contiguous(), activation)
    else:
        out = ffn_plain(x2, w1, b1, w2, b2, activation)
    return out.reshape(*batch_shape, d)
