"""Vector-quantisation codebook search (nearest neighbour, L2).

Counterpart of ``enhancing_tpu/ops/vq.py``. ``nearest_codebook_indices``
runs the kernel ``csrc/vq.cu`` on CUDA: scores ``|e|^2 - 2 z.e`` in fp32
(the constant ``|z|^2`` dropped), ties to the lowest index, and the
(M, n_embed) score matrix never exists. The kernel forms each fp32
product exactly on the bf16 tensor cores, as six products of three bf16
pieces of each operand (hi*hi in one sum, the five small terms in
another, folded once), after a split pass over the codebook. The plain
version builds the score matrix and takes its argmin; ``torch.argmin``
also returns the first of equal minima.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, cdiv, check_kernel_args, use_kernel

KERNEL_DIMS = (16, 32, 64)
# csrc/vq.cu: codes a ring stage (the products' N), rows a row tile (M),
# at most 4 ring stages, a block's shared memory less 2 KB of slack
# (sm90.cuh's kSmemLimit)
VQ_CODES, VQ_ROWS, VQ_MAX_STAGES, VQ_SMEM_LIMIT = 128, 64, 4, 232448 - 2048


def vq_scratch_bytes(n: int, d: int) -> int:
    """Bytes of the kernel's scratch: the codebook's three bf16 pieces
    (3, n_pad, max(d, 32)) and |e|^2 (n_pad,) fp32, n_pad = n rounded up to
    a stage of codes."""
    n_pad = cdiv(n, VQ_CODES) * VQ_CODES
    return 3 * n_pad * max(d, 32) * 2 + n_pad * 4


def vq_plan(m: int, n: int, d: int, sms: int) -> dict:
    """``etk_vq_plan``'s choice on a card of ``sms`` SMs: padded D, row
    tiles a warpgroup (2 at D <= 32 when 256-row blocks still give every
    SM one), ring stages, dynamic shared memory, blocks and codebook
    tiles."""
    dp = max(d, 32)
    rt = 2 if dp == 32 and cdiv(m, 4 * VQ_ROWS) >= sms else 1
    z_bytes = 2 * rt * 3 * VQ_ROWS * dp * 2
    stage = cdiv(3 * VQ_CODES * dp * 2 + VQ_CODES * 4, 1024) * 1024
    stages = min(VQ_MAX_STAGES, (VQ_SMEM_LIMIT - z_bytes - 1024) // stage)
    return dict(dp=dp, row_tiles=rt, stages=stages,
                smem=z_bytes + stages * stage + 1024,
                grid=cdiv(m, 2 * rt * VQ_ROWS), tiles=cdiv(n, VQ_CODES))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalise like torch.nn.functional.normalize(dim=-1)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def nearest_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z: (M, D), codebook: (N, D) -> (M,) int32 indices of nearest codes."""
    scores = (-2.0 * (z.float() @ codebook.float().t())
              + torch.sum(torch.square(codebook.float()), dim=-1)[None, :])
    return torch.argmin(scores, dim=-1).to(torch.int32)


def nearest_kernel(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/vq.cu`` on CUDA fp32 z (M, D) and codebook (N, D)."""
    m, d = z.shape
    n = codebook.shape[0]
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"vq kernel takes fp32, got {z.dtype} and "
                        f"{codebook.dtype}")
    if d not in KERNEL_DIMS or codebook.shape[1] != d:
        raise ValueError(f"vq kernel takes D in {KERNEL_DIMS}, got z "
                         f"{tuple(z.shape)} and codebook "
                         f"{tuple(codebook.shape)}")
    check_kernel_args("vq", z, codebook)
    scratch = torch.empty((vq_scratch_bytes(n, d),), dtype=torch.uint8,
                          device=z.device)
    idx = torch.empty((m,), dtype=torch.int32, device=z.device)
    cuda_lib.call("etk_vq_nearest", z.data_ptr(), codebook.data_ptr(),
                  scratch.data_ptr(), idx.data_ptr(), m, n, d,
                  cuda_lib.stream())
    LAUNCHES["vq"] += 1
    return idx


@torch.no_grad()
def nearest_codebook_indices(z: torch.Tensor,
                             codebook: torch.Tensor) -> torch.Tensor:
    """Indices of the nearest codebook row (L2) for each row of ``z``.

    z: (..., D) query vectors; codebook: (n_embed, D). Returns int32
    indices shaped like ``z`` minus its last axis. No gradient flows
    through the argmin: both inputs are detached, as the JAX package
    stops their gradient (``enhancing_tpu/ops/vq.py:149-153``), so the
    search runs inside a training step.
    """
    batch_shape = z.shape[:-1]
    z2 = z.detach().reshape(-1, z.shape[-1])
    codebook = codebook.detach()
    if use_kernel(z2, codebook):
        idx = nearest_kernel(z2.contiguous(), codebook.contiguous())
    else:
        idx = nearest_plain(z2, codebook)
    return idx.reshape(batch_shape)


def codebook_distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Full (..., n_embed) squared-L2 distance matrix (the Gumbel logits
    need all of it), as plain torch."""
    zsq = torch.sum(torch.square(z), dim=-1, keepdim=True)
    esq = torch.sum(torch.square(codebook), dim=-1)
    cross = torch.einsum("...d,nd->...n", z, codebook)
    return zsq + esq - 2.0 * cross
