"""ViT encoder/decoder of the VQGAN tokenizer, in PyTorch.

Counterpart of ``enhancing_tpu/models/stage1/layers.py`` (its default
branches; the W8A8, ``ffn_impl='fused'`` and ``ENHANCING_TPU_ATTN_PROJ``
options are later slices of the port):

- Images are NHWC. Patch embed and un-embed are reshape + Linear, with
  patch pixels flattened in (C, ph, pw) order.
- Fixed 2-D sin-cos position embeddings, added in the compute dtype.
- Pre-norm blocks whose LayerNorms are fused into the next GEMM
  (``ops.fused_ln_gemm``): LN1 -> to_qkv -> attention -> to_out, added to
  the residual inside ``Attention``; LN2 -> fc1 + tanh -> fc2 -> residual;
  then a final single-pass LayerNorm (``ops.fused_layernorm``).

Submodules are named after the JAX parameter tree (``layers_{i}.attn.
to_qkv``, ``norm1``, ``ff.fc1``, ...), so ``compat.from_jax`` maps one
onto the other mechanically. Linear weights are stored in the compute
dtype, as the JAX modules cast them; LayerNorm parameters and the fc1
bias (added in fp32 by the fused kernel) stay fp32.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops.attention import multihead_attention_packed_qkv
from ...ops.ln_gemm import fused_layernorm, fused_ln_gemm

Size = Union[int, Tuple[int, int], Sequence[int]]


def _pair(x: Size) -> Tuple[int, int]:
    if isinstance(x, int):
        return (x, x)
    a, b = x
    return (int(a), int(b))


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: Size) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding, (grid_h*grid_w, embed_dim).

    Half the channels encode one grid coordinate and half the other, each
    as [sin(pos*omega), cos(pos*omega)] with omega = 1/10000^(2i/d),
    computed in float64 and returned as float32.
    """
    gh, gw = _pair(grid_size)
    grid_h = np.arange(gh, dtype=np.float64)
    grid_w = np.arange(gw, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w varies fastest
    grid = np.stack(grid, axis=0).reshape(2, -1)

    def _1d(dim: int, pos: np.ndarray) -> np.ndarray:
        assert dim % 2 == 0
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    assert embed_dim % 2 == 0
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def dense(in_features: int, out_features: int, *, bias: bool = True,
          generator: torch.Generator | None = None) -> nn.Linear:
    """nn.Linear with Xavier-uniform weights and zero bias, as the JAX
    package initialises its Dense kernels, drawn from ``generator``."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features,
                               bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class LayerNormParams(nn.Module):
    """A LayerNorm's fp32 ``weight`` (flax ``scale``) and ``bias``, owned by
    the block and handed to the fused kernel of the layer that follows."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class FeedForward(nn.Module):
    """LN -> fc1 + tanh (one fused kernel) -> fc2. The stage-1 FFN uses
    tanh, not GELU."""

    def __init__(self, dim: int, hidden_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.fc1 = dense(dim, hidden_dim, generator=generator)
        self.fc2 = dense(hidden_dim, dim, generator=generator)
        self.fc1.weight.data = self.fc1.weight.data.to(dtype)
        self.fc2.to(dtype)

    def forward(self, x: torch.Tensor, ln: LayerNormParams) -> torch.Tensor:
        h = fused_ln_gemm(x.to(self.dtype), ln.weight, ln.bias,
                          self.fc1.weight, self.fc1.bias, activation="tanh")
        return self.fc2(h)


class Attention(nn.Module):
    """Multi-head self-attention: LN -> to_qkv (no bias, one fused kernel)
    -> attention on the packed qkv buffer -> to_out (when (heads, dim_head)
    != (1, dim)) -> + residual. scale = dim_head**-0.5."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.to_qkv = dense(dim, inner * 3, bias=False,
                            generator=generator).to(dtype)
        self.has_proj = not (heads == 1 and dim_head == dim)
        if self.has_proj:
            self.to_out = dense(inner, dim, generator=generator).to(dtype)

    def forward(self, x: torch.Tensor, ln: LayerNormParams,
                residual: torch.Tensor) -> torch.Tensor:
        """Returns ``residual + to_out(attention(LN(x)))``."""
        qkv = fused_ln_gemm(x.to(self.dtype), ln.weight, ln.bias,
                            self.to_qkv.weight)
        out = multihead_attention_packed_qkv(qkv, self.heads, self.dim_head,
                                             scale=self.dim_head**-0.5)
        if self.has_proj:
            out = self.to_out(out)
        return residual.to(out.dtype) + out


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.norm1 = LayerNormParams(dim)
        self.attn = Attention(dim, heads, dim_head, dtype=dtype,
                              generator=generator)
        self.norm2 = LayerNormParams(dim)
        self.ff = FeedForward(dim, mlp_dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x, self.norm1, residual=x)
        return x + self.ff(x, self.norm2)


class Transformer(nn.Module):
    """Pre-norm ViT stack (``layers_0`` ... ``layers_{depth-1}``) with a
    final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}", TransformerBlock(
                dim, heads, dim_head, mlp_dim, dtype=dtype,
                generator=generator))
        self.norm = LayerNormParams(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layers_{i}")(x)
        return fused_layernorm(x.to(self.dtype), self.norm.weight,
                               self.norm.bias)


class ViTEncoder(nn.Module):
    """Patchify -> patch_embed -> + pos_embed -> Transformer."""

    def __init__(self, image_size: Size, patch_size: Size, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        ih, iw = _pair(image_size)
        self.patch = _pair(patch_size)
        ph, pw = self.patch
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        self.grid = (ih // ph, iw // pw)
        self.dtype = dtype
        self.patch_embed = dense(channels * ph * pw, dim,
                                 generator=generator).to(dtype)
        pos = get_2d_sincos_pos_embed(dim, self.grid)
        self.register_buffer("pos_embed",
                             torch.from_numpy(pos[None]).to(dtype),
                             persistent=False)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dtype=dtype, generator=generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img: (B, H, W, C) in [0, 1] -> tokens (B, N, dim)."""
        b, _, _, c = img.shape
        (gh, gw), (ph, pw) = self.grid, self.patch
        x = img.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, gh * gw, c * ph * pw)
        x = self.patch_embed(x.to(self.dtype))
        return self.transformer(x + self.pos_embed)


class ViTDecoder(nn.Module):
    """+ pos_embed -> Transformer -> to_pixel -> un-patchify."""

    def __init__(self, image_size: Size, patch_size: Size, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        ih, iw = _pair(image_size)
        self.patch = _pair(patch_size)
        ph, pw = self.patch
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        self.grid = (ih // ph, iw // pw)
        self.channels = channels
        pos = get_2d_sincos_pos_embed(dim, self.grid)
        self.register_buffer("pos_embed",
                             torch.from_numpy(pos[None]).to(dtype),
                             persistent=False)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dtype=dtype, generator=generator)
        self.to_pixel = dense(dim, channels * ph * pw,
                              generator=generator).to(dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, N, dim) -> img (B, H, W, C)."""
        x = self.transformer(tokens + self.pos_embed.to(tokens.dtype))
        x = self.to_pixel(x)
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid, self.patch
        x = x.reshape(b, gh, gw, self.channels, ph, pw)
        return x.permute(0, 1, 4, 2, 5, 3).reshape(
            b, gh * ph, gw * pw, self.channels)
