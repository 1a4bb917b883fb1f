"""Vector-quantisation codebook search (nearest neighbour, L2).

Counterpart of ``enhancing_tpu/ops/vq.py``. ``nearest_codebook_indices``
runs the kernel ``csrc/vq.cu`` on CUDA: scores ``|e|^2 - 2 z.e`` in fp32
(the constant ``|z|^2`` dropped), ties to the lowest index, and the
(M, n_embed) score matrix never exists. The plain version builds that
matrix and takes its argmin; ``torch.argmin`` also returns the first of
equal minima.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

KERNEL_DIMS = (16, 32, 64)


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
    esq = torch.sum(torch.square(codebook), dim=-1)
    idx = torch.empty((m,), dtype=torch.int32, device=z.device)
    cuda_lib.call("etk_vq_nearest", z.data_ptr(), codebook.data_ptr(),
                  esq.data_ptr(), idx.data_ptr(), m, n, d, cuda_lib.stream())
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
