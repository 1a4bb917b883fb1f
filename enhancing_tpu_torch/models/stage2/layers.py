"""Stage-2 autoregressive GPT prior over tokenizer codes, in PyTorch.

Counterpart of the GPT of ``enhancing_tpu/models/stage2/layers.py`` (its
default branches):

- :class:`MultiHeadSelfAttention` keeps the RWKV-style token shift (a
  learned per-channel ``time_mix`` ramp blending x with its one-step-delayed
  copy, ``:105-113``) and the prefix-causal mask; the full sequence goes
  through ``ops.multihead_attention_bnhd`` (B8 on CUDA).
- :class:`FFN` is the 4x squared-ReLU MLP.
- :class:`GPT` has the full forward (training), ``init_cache``, ``prefill``
  and ``decode_step``. The decode step keeps the JAX structure: the
  stacked (L, B, ctx, C) caches are read-only inside the layer loop, each
  layer's attention (``ops.decode_attention_stacked``, B9 on CUDA) folds
  the current token's key and value in as an extra softmax term, and after
  the last layer the step writes the k stack once and the v stack once
  (``ops.cache_row_update``, B10). The real per-layer token-shift state is
  carried through decode, the JAX package's deliberate divergence from the
  original repository (``layers.py:16-20`` there).

Numerics, as flax computes them under a bf16 ``dtype``: the embeddings are
fp32 (``nn.Embed`` has no dtype), so the residual stream is fp32, and each
block adds its bf16 branch outputs into it; LayerNorm statistics are fp32
and its output, the token shift, q/k/v, the KV cache, the shift state and
the logits are in the compute dtype. A flax Dense rounds the product to
bf16 and adds the bias in bf16; the port's stage-1 ``Dense``, used here
too, adds the bias inside the GEMM (one rounding; ROADMAP C). The GEMM
weights are stored in the compute dtype: flax keeps fp32 parameters and
casts them at each use, which gives the same numbers, and a bf16 prior
stored so is cast once, when its weights are drawn or loaded, instead of
at each of a sample's decode steps.

Submodules are named after the JAX tree with ``scan_layers=False``
(``blocks_{i}.ln1``, ``blocks_{i}.attn.query``, ``blocks_{i}.mlp.p0``,
``tok_emb_code``, ``head``, ...); ``compat.load_gpt_from_jax`` also takes
the stacked tree of ``scan_layers=True``. ``scan_layers`` and ``remat``
choose how XLA compiles the JAX model and mean nothing here. The int8
options (``kv_int8``, ``act_int8``; ROADMAP A8), ``sp_mesh`` (A9) and the
opt-in ``ENHANCING_TPU_DECODE_LNFUSE`` fusions (queue B11) raise.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import (decode_attention_stacked,
                              multihead_attention_bnhd)
from ...ops.cache import cache_row_update
from ...ops.common import resolve_device
from ..stage1.layers import Dense
from ..stage1.vitvqgan import DTYPES


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{name!r}")
    return DTYPES[name]


def refuse_lnfuse() -> None:
    """The JAX decode folds LayerNorm into its GEMMs when
    ENHANCING_TPU_DECODE_LNFUSE names a site; that kernel is not ported."""
    if os.environ.get("ENHANCING_TPU_DECODE_LNFUSE", "none") not in (
            "none", "0", ""):
        raise NotImplementedError(
            "ENHANCING_TPU_DECODE_LNFUSE: the fused LN + token shift + GEMM "
            "decode kernel is not ported yet (ROADMAP queue B11)")


def _dense(in_features: int, out_features: int, bias: bool,
           dtype: torch.dtype) -> Dense:
    """A GEMM of the prior, its weights stored in the compute dtype."""
    return Dense(in_features, out_features, bias=bias, dtype=dtype,
                 param_dtype=dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon=1e-5, dtype=...)``: fp32 weight (flax
    ``scale``) and bias, fp32 statistics, output in the compute dtype."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, n_heads: int, cond_len: int,
                 attn_bias: bool = True, use_mask: bool = True, *,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if embed_dim % n_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"n_heads {n_heads}")
        self.embed_dim, self.n_heads = embed_dim, n_heads
        self.head_dim = embed_dim // n_heads
        self.cond_len, self.use_mask, self.dtype = cond_len, use_mask, dtype
        self.key = _dense(embed_dim, embed_dim, attn_bias, dtype)
        self.query = _dense(embed_dim, embed_dim, attn_bias, dtype)
        self.value = _dense(embed_dim, embed_dim, attn_bias, dtype)
        self.proj = _dense(embed_dim, embed_dim, attn_bias, dtype)
        self.time_mix = nn.Parameter(torch.empty(1, 1, embed_dim))

    def token_shift(self, x: torch.Tensor,
                    prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x*tm + delay(x)*(1-tm) in x's dtype; ``prev`` (B, C) is the
        previous token's state for a one-token decode."""
        tm = self.time_mix.to(x.dtype)
        if x.shape[1] == 1 and prev is not None:
            shifted = prev[:, None, :]
        else:
            shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
        return x * tm + shifted * (1.0 - tm)

    def _attend(self, x: torch.Tensor):
        b, t, c = x.shape
        split = (b, t, self.n_heads, self.head_dim)
        q = self.query(x).view(split)
        k = self.key(x).view(split)
        v = self.value(x).view(split)
        return q, k, v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward (training and the teacher-forced check)."""
        b, t, c = x.shape
        q, k, v = self._attend(self.token_shift(x))
        y = multihead_attention_bnhd(
            q, k, v, scale=self.head_dim ** -0.5,
            mask_mode="prefix_causal" if self.use_mask else "none",
            cond_len=self.cond_len)
        return self.proj(y.reshape(b, t, c))

    def prefill(self, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor) -> torch.Tensor:
        """Forward of the T-token prefix, writing its keys and values into
        rows [0, T) of this layer's (B, ctx, C) cache views in place."""
        b, t, c = x.shape
        q, k, v = self._attend(self.token_shift(x))
        k_cache[:, :t] = k.reshape(b, t, c)
        v_cache[:, :t] = v.reshape(b, t, c)
        y = multihead_attention_bnhd(
            q, k, v, scale=self.head_dim ** -0.5,
            mask_mode="prefix_causal" if self.use_mask else "none",
            cond_len=self.cond_len)
        return self.proj(y.reshape(b, t, c))

    def decode(self, x: torch.Tensor, k_stack: torch.Tensor,
               v_stack: torch.Tensor, cur_len, shift_prev: torch.Tensor,
               layer: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One-token decode, read-only on the stacked caches.

        x: (B, 1, C), already LayerNorm'd; k_stack / v_stack: the whole
        (L, B, ctx, C) stacks, rows < cur_len valid, ``layer`` selecting
        this block's; shift_prev: (B, C). Returns (attention output,
        k_new, v_new), each (B, 1, C): the caller writes k_new and v_new.
        """
        x = self.token_shift(x, prev=shift_prev)
        q, k_new, v_new = self.query(x), self.key(x), self.value(x)
        # q scaled in its dtype by the scale rounded to that dtype
        scale = float(torch.tensor(self.head_dim ** -0.5, dtype=q.dtype))
        y = decode_attention_stacked(
            q[:, 0] * scale, k_stack, v_stack, k_new[:, 0].to(k_stack.dtype),
            v_new[:, 0].to(v_stack.dtype), cur_len, layer,
            head_dim=self.head_dim)
        return self.proj(y[:, None, :].to(q.dtype)), k_new, v_new


class FFN(nn.Module):
    """4x expansion with squared ReLU."""

    def __init__(self, embed_dim: int, mlp_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.p0 = _dense(embed_dim, 4 * embed_dim, mlp_bias, dtype)
        self.p1 = _dense(4 * embed_dim, embed_dim, mlp_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.p1(torch.square(F.relu(self.p0(x))))


class Block(nn.Module):
    """Pre-LN attention + MLP residual block."""

    def __init__(self, embed_dim: int, n_heads: int, cond_len: int,
                 mlp_bias: bool = True, attn_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, dtype=dtype)
        self.attn = MultiHeadSelfAttention(embed_dim, n_heads, cond_len,
                                           attn_bias, dtype=dtype)
        self.mlp = FFN(embed_dim, mlp_bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def prefill(self, x, k_cache, v_cache):
        """Returns (x, new shift state (B, C)); fills the cache views."""
        h = self.ln1(x)
        x = x + self.attn.prefill(h, k_cache, v_cache)
        return x + self.mlp(self.ln2(x)), h[:, -1, :]

    def decode(self, x, k_stack, v_stack, cur_len, shift_prev, layer):
        """Returns (x, k_new, v_new, new shift state); the caches are
        read-only here."""
        h = self.ln1(x)
        a, k_new, v_new = self.attn.decode(h, k_stack, v_stack, cur_len,
                                           shift_prev, layer)
        x = x + a
        return x + self.mlp(self.ln2(x)), k_new, v_new, h[:, -1, :]


class GPT(nn.Module):
    """Class-conditional GPT prior over tokenizer codes.

    ``device`` defaults to ``cuda``; ``dtype`` is the compute dtype
    (``"float32"`` or ``"bfloat16"``), in which the GEMM weights are also
    stored; the embeddings, LayerNorms, position embeddings and
    ``time_mix`` are fp32, as the JAX module reads them. The prior's
    training step, a later slice, decides its fp32 master weights
    (ROADMAP A4). Random weights are drawn on
    ``device`` from ``torch.Generator(device).manual_seed(seed)``: normal
    (std 0.02) GEMM kernels and token embeddings, zero biases and position
    embeddings, the ``time_mix`` ramp i / (C - 1).
    """

    def __init__(self, vocab_cond_size: int, vocab_img_size: int,
                 embed_dim: int, cond_num_tokens: int, img_num_tokens: int,
                 n_heads: int, n_layers: int, mlp_bias: bool = True,
                 attn_bias: bool = True, dtype: str = "float32",
                 scan_layers: bool = True, remat: bool = False,
                 kv_int8: bool = False, act_int8: bool = False,
                 sp_mesh=None, *,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0) -> None:
        super().__init__()
        if kv_int8 or act_int8:
            raise NotImplementedError(
                "kv_int8 / act_int8: int8 serving is a later slice of the "
                "port (ROADMAP A8)")
        if sp_mesh is not None:
            raise NotImplementedError(
                "sp_mesh: multi-GPU parallelism is a later slice of the "
                "port (ROADMAP A9)")
        self.vocab_cond_size = vocab_cond_size
        self.vocab_img_size = vocab_img_size
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.cond_num_tokens = cond_num_tokens
        self.img_num_tokens = img_num_tokens
        self.dtype = _dtype(dtype)
        self.device = resolve_device(device)
        with torch.device("meta"):
            # flax nn.Embed: fp32 tables whose lookups stay fp32
            self.tok_emb_cond = nn.Embedding(vocab_cond_size, embed_dim)
            self.pos_emb_cond = nn.Parameter(
                torch.empty(1, cond_num_tokens, embed_dim))
            self.tok_emb_code = nn.Embedding(vocab_img_size, embed_dim)
            self.pos_emb_code = nn.Parameter(
                torch.empty(1, img_num_tokens, embed_dim))
            for i in range(n_layers):
                self.add_module(f"blocks_{i}", Block(
                    embed_dim, n_heads, cond_num_tokens, mlp_bias, attn_bias,
                    dtype=self.dtype))
            self.layer_norm = LayerNorm(embed_dim, dtype=self.dtype)
            self.head = _dense(embed_dim, vocab_img_size, False, self.dtype)
        self.to_empty(device=self.device)
        self.reset_parameters(torch.Generator(self.device).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("pos_emb_") or leaf == "bias":
                p.zero_()
            elif ".ln" in name or name.startswith("layer_norm"):
                p.fill_(1.0)
            elif leaf == "time_mix":
                c = p.shape[-1]
                p.copy_((torch.arange(c, dtype=torch.float32) / max(c - 1, 1))
                        .reshape(p.shape))
            else:  # GEMM kernels and token embeddings
                p.normal_(0.0, 0.02, generator=generator)

    @property
    def ctx_len(self) -> int:
        return self.cond_num_tokens + self.img_num_tokens

    @property
    def blocks(self):
        return [getattr(self, f"blocks_{i}") for i in range(self.n_layers)]

    # -- full forward ---------------------------------------------------------

    def embed_input(self, codes: torch.Tensor,
                    conds: torch.Tensor) -> torch.Tensor:
        """Token + position embeddings -> the (B, ctx, C) fp32 block input."""
        codes = codes.reshape(codes.shape[0], -1)
        conds = conds.reshape(conds.shape[0], -1)
        ce = self.tok_emb_code(codes) + self.pos_emb_code.to(self.dtype)
        cc = self.tok_emb_cond(conds) + self.pos_emb_cond.to(self.dtype)
        return torch.cat([cc, ce], dim=1)

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        """Final LN + prediction-window slice + vocab head."""
        x = self.layer_norm(x)
        return self.head(x[:, self.cond_num_tokens - 1:-1])

    def forward(self, codes: torch.Tensor,
                conds: torch.Tensor) -> torch.Tensor:
        """codes (B, img_num_tokens), conds (B, cond_num_tokens) ints ->
        logits (B, img_num_tokens, vocab_img_size): position t predicts
        code t from the condition and codes < t."""
        x = self.embed_input(codes, conds)
        for block in self.blocks:
            x = block(x)
        return self.project_out(x)

    # -- cached sampling ------------------------------------------------------

    def init_cache(self, batch: int, dtype: torch.dtype | None = None
                   ) -> Dict[str, torch.Tensor]:
        """Zeroed (L, B, ctx, C) k and v stacks, ctx padded to a multiple
        of 8, and the (L, B, C) token-shift state, in the compute dtype."""
        dt = self.dtype if dtype is None else dtype
        ctx_pad = -(-self.ctx_len // 8) * 8
        shape = (self.n_layers, batch, ctx_pad, self.embed_dim)
        return {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
            "shift": torch.zeros((self.n_layers, batch, self.embed_dim),
                                 dtype=dt, device=self.device),
        }

    def prefill(self, conds: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the condition prefix, filling cache rows [0, cond_num_tokens)
        in place; returns the logits for code token 0 and the cache."""
        conds = conds.reshape(conds.shape[0], -1)
        x = self.tok_emb_cond(conds) + self.pos_emb_cond.to(self.dtype)
        shifts = []
        for i, block in enumerate(self.blocks):
            x, s = block.prefill(x, cache["k"][i], cache["v"][i])
            shifts.append(s)
        cache["shift"] = torch.stack(shifts).to(cache["shift"].dtype)
        x = self.layer_norm(x)
        return self.head(x[:, self.cond_num_tokens - 1]), cache

    def decode_step(self, token: torch.Tensor, step,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token: (B,) code sampled at position step - 1 (step >= 1).

        ``step``: an int (the lockstep sampler) or a (B,) tensor of per-row
        positions (a ragged batch). Returns the logits predicting code
        position ``step`` and the cache, updated in place. (The JAX
        package's static ``window`` read bound has no counterpart: the
        kernel reads only rows < cur_len.)
        """
        refuse_lnfuse()
        if isinstance(step, int):
            pos = self.pos_emb_code[0, step - 1][None, None, :]
        else:
            pos = self.pos_emb_code[0][step.long() - 1][:, None, :]
        x = self.tok_emb_code(token)[:, None, :] + pos.to(self.dtype)
        cur_len = self.cond_num_tokens + step - 1
        k_all, v_all = cache["k"], cache["v"]
        k_cols, v_cols, s_cols = [], [], []
        for i, block in enumerate(self.blocks):
            x, k, v, s = block.decode(x, k_all, v_all, cur_len,
                                      cache["shift"][i], i)
            k_cols.append(k)
            v_cols.append(v)
            s_cols.append(s)
        cache["shift"] = torch.stack(s_cols).to(cache["shift"].dtype)
        # one in-place row write per stack, after the last layer
        cache_row_update(k_all, torch.stack(k_cols), cur_len)
        cache_row_update(v_all, torch.stack(v_cols), cur_len)
        return self.head(self.layer_norm(x)[:, -1]), cache
