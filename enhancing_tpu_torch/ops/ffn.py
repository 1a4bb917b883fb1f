"""Fused position-wise FFN: act(x @ W1^T + b1) @ W2^T + b2 in one kernel.

Counterpart of ``enhancing_tpu/ops/ffn.py``. ``fused_ffn`` keeps the
(tokens, mlp_dim) hidden out of device memory (B16: CUDA kernels
``csrc/ffn.cu`` in bf16, ``csrc/ffn_f32.cu`` in fp32). The plain version
computes the kernel's numerics (``_ffn_kernel``), not ``_ffn_xla``'s: the
hidden is an fp32 product plus the fp32 bias, the activation runs in
fp32, the hidden is rounded to the compute dtype before W2, the W2
products sum in fp32, then + b2 in fp32 and one rounding. In f32 the two
are the same function; in bf16 ``_ffn_xla`` rounds after each dot and
adds the biases in bf16 (the port's LN -> GEMM copies its kernel
likewise, ROADMAP §C).

On CUDA the entry point is a ``torch.autograd.Function``: the forward is
the kernel, the backward autograd of the plain version recomputed from
the saved inputs, as ``_ffn_fused_bwd`` takes the VJP of ``_ffn_xla``.
fp32 x goes where :func:`ffn_route` sends it. The JAX package runs its
kernel in fp32 where the weights take at most ``_MAX_WEIGHT_BYTES`` (12
MiB, ``ffn.py:133,146-160``: Small's 2 x 512 x 2048 x 4 = 8.4 MB), and
so does the port (``csrc/ffn_f32.cu``: the split pass into exact bf16
pieces, then one launch of a cluster kernel whose plan ``ffn_f32_plan``
mirrors); above that (Base's 2 x 768 x 3072 x 4 bytes = 18.9 MB) both
compute the unfused form, ``_ffn_xla``, here two fp32 library products
(:func:`ffn_unfused`).

Weights use torch's Linear layout: ``w1: (h, d)``, ``w2: (d, h)``. For
bf16 x the JAX dispatch limits that exist for VMEM and the 128 lanes (``_MAX_WEIGHT_BYTES``,
``d % 128``, ``_H_CHUNK`` divisibility, ``ffn.py:131-155``) are not
reproduced: the XLA path they fall back to computes the same function in
f32. The bf16 kernel takes bf16 x and weights, fp32 biases, d and h
multiples of 64 and d up to 2048 (every stage-1 config: d 64-1280, h
128-5120), the fp32 kernel fp32 x, weights and biases, d and h multiples
of 64 and d up to 1024; both raise otherwise. ``ffn_plan`` and
``ffn_f32_plan`` mirror the kernels' choices of cluster.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import (F32_LAUNCHES, LAUNCHES, UNFUSED_CALLS,
                     check_kernel_args, use_kernel)
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


# csrc/ffn_f32.cu's shapes: 64-row blocks of one consumer warpgroup in
# clusters of C = ceil(d / 128) (at most 8), each block owning an output
# slab of 128 columns (64 at d = 64); the hidden walked in 64-wide chunks,
# each handed over as register fragments of its three bf16 pieces (64 x 64
# x 6 bytes a hidden buffer, two of them); a ring stage holds an x and a W1
# tile, or a W2 box, in three pieces
FFN_F32_MAX_CLUSTER, FFN_F32_MAX_STAGES = 8, 4
FFN_F32_MAX_D = FFN_F32_MAX_CLUSTER * 128


def ffn_f32_plan(d: int) -> dict | None:
    """The fp32 kernel's cluster for width d, as ``csrc/ffn_f32.cu::
    ffn_plan`` picks it (the C entry ``etk_ffn_f32_plan`` returns the same
    numbers): C = ceil(d / 128) blocks of 128-column slabs (one of 64 at d
    = 64); as many ring stages as shared memory holds beside the two hidden
    buffers, at most 4. None where d is not a multiple of 64 or above
    1024."""
    if d <= 0 or d % 64 or d > FFN_F32_MAX_D:
        return None
    slab = 64 if d <= 64 else 128
    tile = 3 * 64 * 64 * 2  # a (64, 64) box or hidden chunk, three pieces
    stage = max(2 * tile, 3 * slab * 64 * 2)
    stages = min(FFN_F32_MAX_STAGES,
                 (FFN_SMEM_LIMIT - 1024 - 2 * tile) // stage)
    return dict(cluster=-(-d // 128), slab=slab, chunk=FFN_CHUNK,
                stages=stages, smem=2 * tile + stages * stage + 1024)


def ffn_plain(x, w1, b1, w2, b2, activation="tanh"):
    """Plain version of the fused FFN kernel on 2-D x (m, d)."""
    h = x.float() @ w1.to(x.dtype).float().t() + b1.float()
    h = _act(h, activation).to(x.dtype)
    out = h.float() @ w2.to(x.dtype).float().t() + b2.float()
    return out.to(x.dtype)


# the JAX fused_ffn's kernel limits (enhancing_tpu/ops/ffn.py:50,133,
# 146-156): weights of at most 12 MiB, d and h multiples of 128, h whole
# 512-wide chunks (or below 512), at least 8 rows
JAX_FFN_MAX_WEIGHT_BYTES, JAX_FFN_H_CHUNK = 12 * 1024 * 1024, 512


def jax_fuses_ffn(dtype: torch.dtype, rows: int, d: int, h: int) -> bool:
    """Whether the JAX ``fused_ffn`` (``impl="pallas"``, as the stage-1
    FFN calls it) runs its kernel ``_ffn_pallas`` at this shape, else
    ``_ffn_xla``."""
    weight_bytes = 2 * d * h * (4 if dtype == torch.float32 else 2)
    return (rows >= 8 and weight_bytes <= JAX_FFN_MAX_WEIGHT_BYTES
            and d % 128 == 0 and h % 128 == 0
            and h % min(JAX_FFN_H_CHUNK, h) == 0)


def ffn_route(dtype: torch.dtype, rows: int, d: int, h: int) -> str:
    """Where ``fused_ffn`` on CUDA goes, decided from x's dtype and the
    shape before any launch: ``"ffn"`` (B16) for bf16 x on ``csrc/ffn.cu``,
    which raises there for a width it does not take, and for fp32 x on
    ``csrc/ffn_f32.cu`` where the JAX package runs its kernel
    (:func:`jax_fuses_ffn`: weights of at most 12 MiB) and
    :func:`ffn_f32_plan` takes d; otherwise for fp32 x :func:`ffn_unfused`,
    as ``"unfused"`` where the JAX package too computes ``_ffn_xla`` and as
    ``"unported"`` where it runs its kernel at a width the port's plan
    refuses (ROADMAP.md queue B item 0). Raises TypeError for another
    dtype."""
    if dtype == torch.bfloat16:
        return "ffn"
    if dtype == torch.float32:
        if not jax_fuses_ffn(dtype, rows, d, h):
            return "unfused"
        return "ffn" if ffn_f32_plan(d) is not None else "unported"
    raise TypeError(f"fused_ffn takes bf16 or fp32 x, got {dtype}")


def ffn_unfused(x, w1, b1, w2, b2, activation="tanh"):
    """``_ffn_xla`` on 2-D x (m, d) with torch's Linear layout: fc1 + b1 ->
    activation -> fc2 + b2 in x's dtype, two library products (fp32 with
    TF32 as the caller set it: off by default). In fp32 the same function
    as :func:`ffn_plain`."""
    hidden = _act(x @ w1.t() + b1.to(x.dtype), activation)
    return hidden @ w2.t() + b2.to(x.dtype)


def ffn_kernel(x, w1, b1, w2, b2, activation="tanh"):
    """Launch B16 on CUDA x (m, d), w1 (h, d), w2 (d, h), all bf16
    (``csrc/ffn.cu``) or all fp32 (``csrc/ffn_f32.cu``: the split pass
    into exact bf16 pieces, then one launch), and fp32 b1 (h,), b2 (d,),
    all contiguous; counted under ``ffn`` and, in fp32, in
    ``F32_LAUNCHES``."""
    m, d = x.shape
    h = w1.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != x.dtype for t in (w1, w2)) or any(
            t.dtype != torch.float32 for t in (b1, b2)):
        raise TypeError("ffn kernel takes x, w1, w2 all bf16 or all fp32, "
                        "and fp32 biases")
    if (w1.shape != (h, d) or w2.shape != (d, h) or b1.shape != (h,)
            or b2.shape != (d,)):
        raise ValueError(f"ffn: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)} and the biases do not fit")
    f32 = x.dtype == torch.float32
    most = FFN_F32_MAX_D if f32 else FFN_MAX_D
    if d % 64 or h % 64 or d > most:
        raise ValueError(f"ffn kernel needs d % 64 == 0, h % 64 == 0 and "
                         f"d <= {most} in {str(x.dtype)[6:]}, got d={d}, "
                         f"h={h} (fused_ffn sends other shapes to the unfused"
                         " form: ffn_route)")
    if activation not in FFN_ACTIVATIONS:
        raise ValueError(f"ffn activation must be one of {FFN_ACTIVATIONS}")
    check_kernel_args("ffn", x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, out)]
    if f32:
        pieces = torch.empty(3 * (m * d + 2 * h * d), dtype=torch.bfloat16,
                             device=x.device)
        cuda_lib.call("etk_ffn_f32", *ptrs, pieces.data_ptr(), m, d, h,
                      ACTIVATIONS[activation], cuda_lib.stream())
        F32_LAUNCHES["ffn"] += 1
    else:
        cuda_lib.call("etk_ffn", *ptrs, m, d, h, ACTIVATIONS[activation],
                      cuda_lib.stream())
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
    b2: (d,), applied in fp32. CUDA tensors go where :func:`ffn_route`
    sends them (the kernel: bf16 at every width, fp32 where the JAX package
    runs its kernel too; else :func:`ffn_unfused`, counted in
    ``UNFUSED_CALLS``), CPU tensors to the plain version.
    """
    if activation not in FFN_ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    if use_kernel(x2, w1, b1, w2, b2, op="ffn"):
        if ffn_route(x.dtype, x2.shape[0], d, w1.shape[0]) != "ffn":
            UNFUSED_CALLS["ffn"] += 1
            out = ffn_unfused(x2, w1, b1, w2, b2, activation)
        else:
            out = _FusedFFN.apply(x2.contiguous(), w1.contiguous(),
                                  b1.float().contiguous(), w2.contiguous(),
                                  b2.float().contiguous(), activation)
    else:
        out = ffn_plain(x2, w1, b1, w2, b2, activation)
    return out.reshape(*batch_shape, d)
