"""Vector / Gumbel / residual quantizers of the ViT-VQGAN tokenizer.

Counterpart of ``enhancing_tpu/models/stage1/quantizers.py``:

- The nearest-code search runs through ``ops.nearest_codebook_indices``
  (the CUDA kernel ``csrc/vq.cu`` on the card), which never builds the
  (tokens, n_embed) distance matrix.
- The residual loop (RQ-VAE) sums the quantised residuals over
  ``num_quantizers`` depths; depth indices stack on the last axis.
- Straight-through estimator ``z + (z_q - z).detach()``, evaluated in that
  order, so the forward value rounds as the JAX one does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.vq import codebook_distances, l2_normalize, nearest_codebook_indices

QuantizerOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _embedding(n_embed: int, embed_dim: int,
               generator: torch.Generator | None) -> nn.Parameter:
    w = torch.empty(n_embed, embed_dim)
    nn.init.normal_(w, std=1.0, generator=generator)
    return nn.Parameter(w)


class VectorQuantizer(nn.Module):
    """l2-normalised ("spherical") nearest-neighbour quantizer. The
    commitment loss is taken on the normalised vectors and z_q is the
    normalised codebook vector. Indices are int32."""

    def __init__(self, embed_dim: int, n_embed: int, beta: float = 0.25,
                 use_norm: bool = True, use_residual: bool = False,
                 num_quantizers: Optional[int] = None,
                 straight_through: bool = True, *,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if use_residual and not num_quantizers:
            raise ValueError("use_residual needs num_quantizers > 0")
        self.beta = beta
        self.use_norm = use_norm
        self.use_residual = use_residual
        self.num_quantizers = num_quantizers
        self.straight_through = straight_through
        self.embedding = _embedding(n_embed, embed_dim, generator)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(x) if self.use_norm else x

    def quantize(self, z: torch.Tensor) -> QuantizerOutput:
        z_norm = self._norm(z)
        e_norm = self._norm(self.embedding)
        indices = nearest_codebook_indices(z_norm, e_norm)
        z_qnorm = self._norm(self.embedding[indices])
        loss = (self.beta * torch.mean(torch.square(z_qnorm.detach() - z_norm))
                + torch.mean(torch.square(z_qnorm - z_norm.detach())))
        return z_qnorm, loss, indices

    def forward(self, z: torch.Tensor) -> QuantizerOutput:
        if not self.use_residual:
            z_q, loss, indices = self.quantize(z)
        else:
            residual = z.detach()
            z_q = torch.zeros_like(z)
            losses, index_list = [], []
            for _ in range(self.num_quantizers):
                z_qi, loss_i, idx_i = self.quantize(residual)
                residual = residual - z_qi
                z_q = z_q + z_qi
                losses.append(loss_i)
                index_list.append(idx_i)
            loss = torch.mean(torch.stack(losses))
            indices = torch.stack(index_list, dim=-1)
        if self.straight_through:
            z_q = z + (z_q - z).detach()
        return z_q, loss, indices

    def embed_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup + norm (+ depth sum when residual)."""
        quant = self._norm(self.embedding[indices])
        if self.use_residual:
            quant = torch.sum(quant, dim=-2)
        return quant


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer with a KL-to-uniform prior loss. The
    deterministic path (``deterministic=True``, used outside training)
    takes the straight-through hard one-hot; otherwise gumbel noise is
    drawn from ``generator`` and the soft relaxation is used."""

    def __init__(self, embed_dim: int, n_embed: int, temp_init: float = 1.0,
                 use_norm: bool = True, use_residual: bool = False,
                 num_quantizers: Optional[int] = None, *,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if use_residual and not num_quantizers:
            raise ValueError("use_residual needs num_quantizers > 0")
        self.n_embed = n_embed
        self.temp_init = temp_init
        self.use_norm = use_norm
        self.use_residual = use_residual
        self.num_quantizers = num_quantizers
        self.embedding = _embedding(n_embed, embed_dim, generator)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(x) if self.use_norm else x

    def quantize(self, z: torch.Tensor, temp: Optional[float] = None,
                 deterministic: bool = True,
                 generator: torch.Generator | None = None) -> QuantizerOutput:
        temp = self.temp_init if temp is None else temp
        e_norm = self._norm(self.embedding)
        logits = -codebook_distances(self._norm(z), e_norm)
        if deterministic:
            y_soft = torch.softmax(logits / temp, dim=-1)
        else:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device, dtype=logits.dtype)
            g = -torch.log(-torch.log(u))
            y_soft = torch.softmax((logits + g) / temp, dim=-1)
        indices = torch.argmax(y_soft, dim=-1).to(torch.int32)
        if deterministic:
            y_hard = nn.functional.one_hot(indices.long(), self.n_embed).to(
                y_soft.dtype)
            y = y_hard - y_soft.detach() + y_soft
        else:
            y = y_soft
        z_q = torch.einsum("...n,nd->...d", y, e_norm)
        logp = torch.log_softmax(logits, dim=-1)
        loss = torch.mean(torch.sum(torch.exp(logp)
                                    * (logp + math.log(self.n_embed)), dim=-1))
        return z_q, loss, indices

    def forward(self, z: torch.Tensor, temp: Optional[float] = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> QuantizerOutput:
        if not self.use_residual:
            return self.quantize(z, temp, deterministic, generator)
        residual = z.detach()
        z_q = torch.zeros_like(z)
        losses, index_list = [], []
        for _ in range(self.num_quantizers):
            z_qi, loss_i, idx_i = self.quantize(residual, temp, deterministic,
                                                generator)
            residual = residual - z_qi
            z_q = z_q + z_qi
            losses.append(loss_i)
            index_list.append(idx_i)
        return (z_q, torch.mean(torch.stack(losses)),
                torch.stack(index_list, dim=-1))

    def embed_codes(self, indices: torch.Tensor) -> torch.Tensor:
        quant = self._norm(self.embedding[indices])
        if self.use_residual:
            quant = torch.sum(quant, dim=-2)
        return quant
