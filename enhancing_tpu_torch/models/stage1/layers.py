"""ViT encoder/decoder of the VQGAN tokenizer, in PyTorch.

Counterpart of ``enhancing_tpu/models/stage1/layers.py`` with its
default branches and its two opt-in fusions. The W8A8 option
(``ENHANCING_TPU_STAGE1_GEMM=w8a8``) is a later slice of the port: a block
refuses it when it is built or called rather than compute another
function than the one asked for.

- Images are NHWC. Patch embed and un-embed are reshape + Linear, with
  patch pixels flattened in (C, ph, pw) order.
- Fixed 2-D sin-cos position embeddings, added in the compute dtype.
- Pre-norm blocks whose LayerNorms are fused into the next GEMM
  (``ops.fused_ln_gemm``): LN1 -> to_qkv -> attention -> to_out, added to
  the residual inside ``Attention``; LN2 -> fc1 + tanh -> fc2 -> residual;
  then a final single-pass LayerNorm (``ops.fused_layernorm``).
- ``ENHANCING_TPU_ATTN_PROJ`` set (read at each call, as JAX reads it at
  each trace): attention -> to_out -> + residual in one kernel
  (``ops.attention_proj_packed``), reading q, k and v straight out of
  the fused qkv buffer.
- ``ffn_impl='fused'`` (a field of the encoder/decoder config, or the
  ``ENHANCING_TPU_FUSED_FFN`` override): LN2 as the single-pass LayerNorm,
  then fc1 + tanh -> fc2 in one kernel (``ops.fused_ffn``).

Submodules are named after the JAX parameter tree (``layers_{i}.attn.
to_qkv``, ``norm1``, ``ff.fc1``, ...), so ``compat.from_jax`` maps one
onto the other mechanically. Parameters are stored in fp32 and cast to
the compute dtype where they are used, as flax keeps fp32 parameters
under a bf16 ``dtype``: training updates the fp32 values. LayerNorm
parameters and the fc1 bias enter the fused kernel in fp32.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import (attention_proj_packed,
                              multihead_attention_packed_qkv)
from ...ops.ffn import fused_ffn
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


class Dense(nn.Linear):
    """nn.Linear with Xavier-uniform weights and zero bias drawn from
    ``generator``, as the JAX package initialises its Dense kernels; the
    weight and bias, stored in ``param_dtype`` (fp32, as flax keeps them),
    are cast to ``dtype`` with the input, as a flax ``Dense(dtype=...)``
    computes. The bias is added inside the GEMM (ROADMAP C).

    ``weight_q`` (int8, the weight's layout) and ``scale`` (fp32, one per
    output channel) are None buffers until the stage-2 prior's
    ``quantize_decode_params`` gives the GEMM its int8 twin; after
    ``drop_quantized_kernels`` the weight is None and only the int8 paths
    run."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(in_features, out_features, bias=bias, device="meta")
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype))
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features,
                                                 dtype=param_dtype))
        self.register_buffer("weight_q", None)
        self.register_buffer("scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            raise RuntimeError(
                "this GEMM's weight was dropped by drop_quantized_kernels: "
                "only its int8 twin remains, which the decode paths read")
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNormParams(nn.Module):
    """A LayerNorm's fp32 ``weight`` (flax ``scale``) and ``bias``, owned by
    the block and handed to the fused kernel of the layer that follows."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def use_fused_attn_proj() -> bool:
    """ENHANCING_TPU_ATTN_PROJ set (and not "0"): fold the output projection
    and the residual add into the attention kernel."""
    return os.environ.get("ENHANCING_TPU_ATTN_PROJ", "") not in ("", "0")


def refuse_w8a8() -> None:
    """Raise if ENHANCING_TPU_STAGE1_GEMM=w8a8 asks for int8 block GEMMs:
    the JAX package then routes qkv, to_out, fc1 and fc2 through int8
    activations and weights, which the port does not have yet."""
    if os.environ.get("ENHANCING_TPU_STAGE1_GEMM") == "w8a8":
        raise NotImplementedError(
            "ENHANCING_TPU_STAGE1_GEMM=w8a8 (int8 activations on int8 "
            "stage-1 GEMMs) is not ported (ROADMAP A8); unset it to run "
            "the bf16/fp32 GEMMs")


def resolve_ffn_impl(ffn_impl: str | None) -> str:
    """The FFN kernel choice: the ENHANCING_TPU_FUSED_FFN env var is an A/B
    override; otherwise the module/config field decides ('dense', the
    default, or 'fused')."""
    env = os.environ.get("ENHANCING_TPU_FUSED_FFN")
    if env is not None:
        return "fused" if env not in ("", "0") else "dense"
    return ffn_impl or "dense"


class FeedForward(nn.Module):
    """LN -> fc1 + tanh (one fused kernel) -> fc2; with ``ffn_impl='fused'``
    LN (one kernel) -> fc1 + tanh -> fc2 (one kernel). The stage-1 FFN uses
    tanh, not GELU."""

    def __init__(self, dim: int, hidden_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 ffn_impl: str | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.ffn_impl = ffn_impl
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, generator=generator)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, ln: LayerNormParams) -> torch.Tensor:
        if resolve_ffn_impl(self.ffn_impl) == "fused":
            xn = fused_layernorm(x.to(self.dtype), ln.weight, ln.bias)
            return fused_ffn(xn, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias,
                             activation="tanh")
        h = fused_ln_gemm(x.to(self.dtype), ln.weight, ln.bias,
                          self.fc1.weight, self.fc1.bias, activation="tanh")
        return self.fc2(h)


class Attention(nn.Module):
    """Multi-head self-attention: LN -> to_qkv (no bias, one fused kernel)
    -> attention on the packed qkv buffer -> to_out (when (heads, dim_head)
    != (1, dim)) -> + residual. scale = dim_head**-0.5. With
    ``ENHANCING_TPU_ATTN_PROJ`` set and a projection, attention -> to_out
    -> + residual is one kernel on the qkv buffer's lane slices."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype,
                            generator=generator)
        self.has_proj = not (heads == 1 and dim_head == dim)
        if self.has_proj:
            self.to_out = Dense(inner, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, ln: LayerNormParams,
                residual: torch.Tensor) -> torch.Tensor:
        """Returns ``residual + to_out(attention(LN(x)))``."""
        qkv = fused_ln_gemm(x.to(self.dtype), ln.weight, ln.bias,
                            self.to_qkv.weight)
        if self.has_proj and use_fused_attn_proj():
            # q, k and v are views of the qkv buffer's lane slices: no copy
            q, k, v = (t.unflatten(-1, (self.heads, self.dim_head))
                       for t in qkv.chunk(3, dim=-1))
            return attention_proj_packed(
                q, k, v, self.to_out.weight, self.to_out.bias,
                residual.to(self.dtype), scale=self.dim_head**-0.5)
        out = multihead_attention_packed_qkv(qkv, self.heads, self.dim_head,
                                             scale=self.dim_head**-0.5)
        if self.has_proj:
            out = self.to_out(out)
        return residual.to(out.dtype) + out


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 ffn_impl: str | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        refuse_w8a8()
        self.norm1 = LayerNormParams(dim)
        self.attn = Attention(dim, heads, dim_head, dtype=dtype,
                              generator=generator)
        self.norm2 = LayerNormParams(dim)
        self.ff = FeedForward(dim, mlp_dim, dtype=dtype, ffn_impl=ffn_impl,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        refuse_w8a8()  # read at each call, as JAX reads it at each trace
        x = self.attn(x, self.norm1, residual=x)
        return x + self.ff(x, self.norm2)


class Transformer(nn.Module):
    """Pre-norm ViT stack (``layers_0`` ... ``layers_{depth-1}``) with a
    final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, *, dtype: torch.dtype = torch.float32,
                 ffn_impl: str | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}", TransformerBlock(
                dim, heads, dim_head, mlp_dim, dtype=dtype,
                ffn_impl=ffn_impl, generator=generator))
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
                 ffn_impl: str | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        ih, iw = _pair(image_size)
        self.patch = _pair(patch_size)
        ph, pw = self.patch
        if ih % ph or iw % pw:
            raise ValueError("image size must divide by patch size")
        self.grid = (ih // ph, iw // pw)
        self.dtype = dtype
        self.patch_embed = Dense(channels * ph * pw, dim, dtype=dtype,
                                 generator=generator)
        pos = get_2d_sincos_pos_embed(dim, self.grid)
        self.register_buffer("pos_embed",
                             torch.from_numpy(pos[None]).to(dtype),
                             persistent=False)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dtype=dtype, ffn_impl=ffn_impl,
                                       generator=generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img: (B, H, W, C) in [0, 1] -> tokens (B, N, dim)."""
        b, _, _, c = img.shape
        (gh, gw), (ph, pw) = self.grid, self.patch
        x = img.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, gh * gw, c * ph * pw)
        x = self.patch_embed(x)
        return self.transformer(x + self.pos_embed)


class ViTDecoder(nn.Module):
    """+ pos_embed -> Transformer -> to_pixel -> un-patchify."""

    def __init__(self, image_size: Size, patch_size: Size, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 ffn_impl: str | None = None,
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
                                       dtype=dtype, ffn_impl=ffn_impl,
                                       generator=generator)
        self.to_pixel = Dense(dim, channels * ph * pw, dtype=dtype,
                              generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, N, dim) -> img (B, H, W, C)."""
        return self.pixels_from_tokens(self.pre_pixel_tokens(tokens))

    def pre_pixel_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Everything up to, not including, the last layer (to_pixel)."""
        return self.transformer(tokens + self.pos_embed.to(tokens.dtype))

    def pixels_from_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer only: to_pixel and un-patchify."""
        x = self.to_pixel(x)
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid, self.patch
        x = x.reshape(b, gh, gw, self.channels, ph, pw)
        return x.permute(0, 1, 4, 2, 5, 3).reshape(
            b, gh * ph, gw * pw, self.channels)

    def patchify_grad(self, g: torch.Tensor) -> torch.Tensor:
        """Inverse of the un-patchify: (B, H, W, C) -> (B, N, C*ph*pw), for
        chaining an image gradient onto the last layer."""
        b = g.shape[0]
        (gh, gw), (ph, pw) = self.grid, self.patch
        g = g.reshape(b, gh, ph, gw, pw, self.channels)
        return g.permute(0, 1, 3, 5, 2, 4).reshape(
            b, gh * gw, self.channels * ph * pw)

    def get_last_layer(self) -> torch.Tensor:
        """The last layer's weight (the reference's
        ``decoder.get_last_layer()``), for the adaptive GAN weight."""
        return self.to_pixel.weight
