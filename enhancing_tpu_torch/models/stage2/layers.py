"""Stage-2 autoregressive priors over tokenizer codes, in PyTorch.

Counterpart of the GPT and the RQTransformer of
``enhancing_tpu/models/stage2/layers.py`` (their default branches):

- :class:`MultiHeadSelfAttention` keeps the RWKV-style token shift (a
  learned per-channel ``time_mix`` ramp blending x with its one-step-delayed
  copy, ``:105-113``) and the prefix-causal mask; the full sequence goes
  through ``ops.multihead_attention_bnhd`` (B8 on CUDA).
- :class:`FFN` is the 4x squared-ReLU MLP.
- :class:`GPT` has the full forward (training), ``init_cache``, ``prefill``
  and ``decode_step``; :class:`RQTransformer` (the RQ prior over residual
  codes) the teacher-forced forward, ``init_cache``, ``spatial_prefill``,
  ``spatial_step`` and ``depth_forward``. Both stacks' cached decode runs
  :func:`prefill_stack` and :func:`decode_stack`. The decode step keeps
  the JAX structure: the stacked (L, B, ctx, C) caches are read-only
  inside the layer loop, each layer's attention
  (``ops.decode_attention_stacked``, B9 on CUDA) folds the current
  token's key and value in as an extra softmax term, and after the last
  layer the step writes the k stack once and the v stack once
  (``ops.cache_row_update``, B10). The real per-layer token-shift state is
  carried through decode, the JAX package's deliberate divergence from the
  original repository (``layers.py:16-20`` there).

Numerics, as flax computes them under a bf16 ``dtype``: the embeddings are
fp32 (``nn.Embed`` has no dtype), so the residual stream is fp32, and each
block adds its bf16 branch outputs into it; LayerNorm statistics are fp32
and its output, the token shift, q/k/v, the KV cache, the shift state and
the logits are in the compute dtype. A flax Dense rounds the product to
bf16 and adds the bias in bf16; the port's stage-1 ``Dense``, used here
too, adds the bias inside the GEMM (one rounding; ROADMAP C). A prior built
to sample stores its GEMM weights in the compute dtype: flax keeps fp32
parameters and casts them at each use, which gives the same numbers, and a
bf16 prior stored so is cast once, when its weights are drawn or loaded,
instead of at each of a sample's decode steps. Training stores them in
fp32 and casts them at each use, as flax does (:func:`fp32_master_weights`,
which the trainer's stage-2 build calls).

Int8 serving (``models/stage2/quantize.py``), the JAX module's int8
branches: once ``quantize_decode_params`` has given the GEMMs their int8
twins, the prefill runs its fused qkv and its projection as int8 GEMMs
(``ops.int8_gemm``, B12) and its MLP as one kernel (``int8_mlp_decode``,
B14); a decode step folds LayerNorm and the token shift into the int8 qkv
product (``int8_ln_gemm``, B13), projects with B12, runs its MLP as B14
and its vocab head as B13 without the shift. Their activations are the
fp32 residual stream, so these products are fp32 (ROADMAP C). With
``kv_int8`` the cache is int8 with per-row fp32 scales (L, B, ctx); the
new rows are quantised per row at each step. The RQ prior's spatial
prefill and spatial steps run the same branches; its depth stack and head
read the full-precision weights. W8A8 (``act_int8``) raises.

``ENHANCING_TPU_DECODE_LNFUSE`` (``all``, ``none`` or a comma list of
``qkv``, ``mlp``, ``head``), read at each ``decode_step``, folds the
LayerNorms of a full-precision decode step into its GEMMs as the JAX
package does: the qkv site through ``fused_ln_shift_gemm`` (B11) on the
one [query | key | value] weight whose row blocks the three Denses'
weights are (``MultiHeadSelfAttention.fused_qkv``), the MLP and head sites
through ``fused_ln_gemm`` (B1) on the fp32 residual stream, which casts
those weights to fp32 at each call, as the JAX wrapper does.

Submodules are named after the JAX tree with ``scan_layers=False``
(``blocks_{i}.ln1``, ``blocks_{i}.attn.query``, ``blocks_{i}.mlp.p0``,
``tok_emb_code``, ``head``, ...); ``compat.load_gpt_from_jax`` also takes
the stacked tree of ``scan_layers=True`` and JAX's ``quant`` collection.
``scan_layers`` and ``remat`` choose how XLA compiles the JAX model and
mean nothing here. ``sp_mesh`` (ROADMAP A9) raises.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import (decode_attention_stacked,
                              multihead_attention_bnhd)
from ...ops.cache import cache_row_update, scale_row_update
from ...ops.common import resolve_device
from ...ops.int8 import (int8_gemm, int8_ln_gemm, int8_mlp_decode,
                         quantize_channelwise)
from ...ops.ln_gemm import fused_ln_gemm, fused_ln_shift_gemm
from ..stage1.layers import Dense
from ..stage1.vitvqgan import DTYPES

LNFUSE_SITES = frozenset({"qkv", "mlp", "head"})


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{name!r}")
    return DTYPES[name]


def lnfuse_sites() -> frozenset:
    """The decode step's LayerNorm fusions that ENHANCING_TPU_DECODE_LNFUSE
    turns on: "all" (or "1"), "none" (or "0", "", unset), or a comma list
    of qkv, mlp, head, as ``_lnfuse_sites`` of the JAX package reads it."""
    v = os.environ.get("ENHANCING_TPU_DECODE_LNFUSE", "none")
    if v in ("all", "1"):
        return LNFUSE_SITES
    if v in ("0", "none", ""):
        return frozenset()
    sites = frozenset(t.strip() for t in v.split(","))
    if not sites <= LNFUSE_SITES:
        raise ValueError(f"ENHANCING_TPU_DECODE_LNFUSE={v!r}: sites are "
                         f"{sorted(LNFUSE_SITES)}, 'all' or 'none'")
    return sites


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


def _mix(x: torch.Tensor, shifted: torch.Tensor,
         tm: torch.Tensor) -> torch.Tensor:
    return x * tm + shifted * (1.0 - tm)


class _TokenShift(torch.autograd.Function):
    """The token shift x * tm + shifted * (1 - tm), tm the fp32 ``time_mix``
    in x's dtype, with autograd's gradients of x and shifted, but
    ``time_mix``'s summed in fp32 from (x - shifted) * g. Autograd of the
    expression (and the JAX package's, of the same expression) rounds the
    two sums of x * g and of shifted * g to x's dtype and subtracts them;
    in bf16 that loses most of the digits where they nearly cancel, as in
    the RQ prior's deep spatial layers (ROADMAP C)."""

    @staticmethod
    def forward(ctx, x, shifted, time_mix):
        tm = time_mix.to(x.dtype)
        ctx.save_for_backward(x, shifted, tm)
        return _mix(x, shifted, tm)

    @staticmethod
    def backward(ctx, g):
        x, shifted, tm = ctx.saved_tensors
        g_tm = ((x.float() - shifted.float()) * g.float()).sum(
            dim=(0, 1), keepdim=True)
        return g * tm, g * (1.0 - tm), g_tm


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
        # the fused qkv product's [query | key | value] weight and bias, whose
        # row blocks the three Denses' parameters are (fused_qkv)
        self.qkv_tied: Dict[str, torch.Tensor] = {}
        # int8 serving: the twins as one buffer, the Denses' weight_q and
        # scale views of it (models/stage2/quantize.py)
        self.register_buffer("qkv_q", None)
        self.register_buffer("qkv_scale", None)

    def fused_qkv(self, attr: str) -> Optional[torch.Tensor]:
        """The [query | key | value] ``weight`` (3C, C) or ``bias`` (3C,) of
        the fused qkv product, None where the Denses have none (or it was
        dropped). It is one tensor whose row blocks the three Denses'
        parameters are, so no step concatenates them; parameters that were
        replaced since (``Module.to``, an assigning load) are tied again
        here, with one copy."""
        parts = [getattr(d, attr) for d in (self.query, self.key, self.value)]
        if parts[0] is None:
            self.qkv_tied.pop(attr, None)
            return None
        fused = self.qkv_tied.get(attr)
        step = parts[0].numel() * parts[0].element_size()
        if fused is None or any(p.data_ptr() != fused.data_ptr() + i * step
                                for i, p in enumerate(parts)):
            with torch.inference_mode(False), torch.no_grad():
                fused = torch.cat(parts)
                n = len(parts[0])
                for i, (dense, p) in enumerate(zip(
                        (self.query, self.key, self.value), parts)):
                    setattr(dense, attr, nn.Parameter(
                        fused[i * n:(i + 1) * n],
                        requires_grad=p.requires_grad))
            self.qkv_tied[attr] = fused
        return fused

    def token_shift(self, x: torch.Tensor,
                    prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x*tm + delay(x)*(1-tm) in x's dtype; ``prev`` (B, C) is the
        previous token's state for a one-token decode. Under grad,
        ``time_mix``'s gradient is summed in fp32 (:class:`_TokenShift`)."""
        if x.shape[1] == 1 and prev is not None:
            shifted = prev[:, None, :]
        else:
            shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
        if torch.is_grad_enabled() and self.time_mix.requires_grad:
            return _TokenShift.apply(x, shifted, self.time_mix)
        return _mix(x, shifted, self.time_mix.to(x.dtype))

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.view(b, n, self.n_heads, self.head_dim)

    def _attend(self, x: torch.Tensor):
        return (self._split(self.query(x)), self._split(self.key(x)),
                self._split(self.value(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward (training and the teacher-forced check)."""
        b, t, c = x.shape
        q, k, v = self._attend(self.token_shift(x))
        y = multihead_attention_bnhd(
            q, k, v, scale=self.head_dim ** -0.5,
            mask_mode="prefix_causal" if self.use_mask else "none",
            cond_len=self.cond_len)
        return self.proj(y.reshape(b, t, c))

    def _project(self, y: torch.Tensor) -> torch.Tensor:
        if self.proj.weight_q is not None:  # int8 output projection
            return int8_gemm(y, self.proj.weight_q, self.proj.scale,
                             self.proj.bias)
        return self.proj(y)

    def prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
        """Forward of the T-token prefix (x LayerNorm'd); returns (output,
        k, v), k and v (B, T, C) for the caller's cache. With int8 twins
        the qkv and the projection are int8 GEMMs."""
        b, t, c = x.shape
        x = self.token_shift(x)
        if self.qkv_q is not None:
            qkv = int8_gemm(x, self.qkv_q, self.qkv_scale,
                            self.fused_qkv("bias"))
            # contiguous: at T = 1 a lane slice's row stride is not the
            # stride that B8 reads rows at
            q, k, v = (self._split(u.contiguous())
                       for u in qkv.split(c, dim=-1))
        else:
            q, k, v = self._attend(x)
        y = multihead_attention_bnhd(
            q, k, v, scale=self.head_dim ** -0.5,
            mask_mode="prefix_causal" if self.use_mask else "none",
            cond_len=self.cond_len)
        return (self._project(y.reshape(b, t, c)), k.reshape(b, t, c),
                v.reshape(b, t, c))

    def decode(self, x, k_stack, v_stack, cur_len, shift_prev, layer,
               k_scale=None, v_scale=None):
        """One-token decode, read-only on the stacked caches.

        x: (B, 1, C), already LayerNorm'd; k_stack / v_stack: the whole
        (L, B, ctx, C) stacks, rows < cur_len valid, ``layer`` selecting
        this block's (with an int8 cache, its (L, B, ctx) row scales);
        shift_prev: (B, C). Returns (attention output, k_new, v_new), each
        (B, 1, C): the caller writes k_new and v_new.
        """
        x = self.token_shift(x, prev=shift_prev)
        q, k_new, v_new = self.query(x), self.key(x), self.value(x)
        return self.attend_project(q, k_new, v_new, k_stack, v_stack,
                                   cur_len, layer, k_scale, v_scale)

    def decode_qkv(self, qkv, k_stack, v_stack, cur_len, layer,
                   k_scale=None, v_scale=None):
        """``decode`` for a caller-computed fused (B, 1, 3C) qkv product
        (LayerNorm and the token shift folded into it)."""
        q, k_new, v_new = qkv.split(self.embed_dim, dim=-1)
        return self.attend_project(q, k_new, v_new, k_stack, v_stack,
                                   cur_len, layer, k_scale, v_scale)

    def attend_project(self, q, k_new, v_new, k_stack, v_stack, cur_len,
                       layer, k_scale=None, v_scale=None):
        """Attention of the new token against the cache, then the output
        projection. The new key and value go in q's dtype beside an int8
        cache, in the cache's dtype otherwise; the output in q's dtype
        (fp32 under int8 weights, whose products are fp32)."""
        # q scaled in its dtype by the scale rounded to that dtype
        scale = float(torch.tensor(self.head_dim ** -0.5, dtype=q.dtype))
        new_dtype = q.dtype if k_scale is not None else k_stack.dtype
        y = decode_attention_stacked(
            q[:, 0] * scale, k_stack, v_stack, k_new[:, 0].to(new_dtype),
            v_new[:, 0].to(new_dtype), cur_len, layer,
            head_dim=self.head_dim, k_scale=k_scale, v_scale=v_scale)
        return self._project(y[:, None, :].to(q.dtype)), k_new, v_new


class FFN(nn.Module):
    """4x expansion with squared ReLU."""

    def __init__(self, embed_dim: int, mlp_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.p0 = _dense(embed_dim, 4 * embed_dim, mlp_bias, dtype)
        self.p1 = _dense(4 * embed_dim, embed_dim, mlp_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.p1(torch.square(F.relu(self.p0(x))))

    def int8_residual(self, x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
        """x + the MLP of LN(x) over the int8 twins, one kernel."""
        return int8_mlp_decode(x, ln.weight, ln.bias, self.p0.weight_q,
                               self.p0.scale, self.p0.bias,
                               self.p1.weight_q, self.p1.scale, self.p1.bias,
                               residual=x, activation="sqrelu", eps=ln.eps)


class Block(nn.Module):
    """Pre-LN attention + MLP residual block."""

    def __init__(self, embed_dim: int, n_heads: int, cond_len: int,
                 mlp_bias: bool = True, attn_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(embed_dim, dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, dtype=dtype)
        self.attn = MultiHeadSelfAttention(embed_dim, n_heads, cond_len,
                                           attn_bias, dtype=dtype)
        self.mlp = FFN(embed_dim, mlp_bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def prefill(self, x):
        """Returns (x, new shift state (B, C), k, v (B, T, C))."""
        h = self.ln1(x)
        a, k, v = self.attn.prefill(h)
        x = x + a
        if self.mlp.p0.weight_q is not None:
            x = self.mlp.int8_residual(x, self.ln2)
        else:
            x = x + self.mlp(self.ln2(x))
        return x, h[:, -1, :], k, v

    def decode(self, x, k_stack, v_stack, cur_len, shift_prev, layer,
               k_scale=None, v_scale=None, sites: frozenset = frozenset()):
        """Returns (x, k_new, v_new, new shift state); the caches are
        read-only here. ``sites``: the LayerNorm fusions on (int8 twins
        take precedence, as in the JAX module)."""
        attn, ln1, ln2, mlp = self.attn, self.ln1, self.ln2, self.mlp
        tm = attn.time_mix.reshape(-1)
        if attn.qkv_q is not None:
            qkv, xn = int8_ln_gemm(x, ln1.weight, ln1.bias, tm,
                                   shift_prev[:, None, :], attn.qkv_q,
                                   attn.qkv_scale, attn.fused_qkv("bias"),
                                   eps=ln1.eps)
        elif "qkv" in sites:
            qkv, xn = fused_ln_shift_gemm(x, ln1.weight, ln1.bias, tm,
                                          shift_prev[:, None, :],
                                          attn.fused_qkv("weight"),
                                          attn.fused_qkv("bias"), eps=ln1.eps)
        else:
            qkv = None
        if qkv is not None:
            new_shift = xn[:, -1, :]
            a, k_new, v_new = attn.decode_qkv(qkv, k_stack, v_stack, cur_len,
                                              layer, k_scale, v_scale)
        else:
            h = ln1(x)
            new_shift = h[:, -1, :]
            a, k_new, v_new = attn.decode(h, k_stack, v_stack, cur_len,
                                          shift_prev, layer, k_scale, v_scale)
        x = x + a
        if mlp.p0.weight_q is not None:
            x = mlp.int8_residual(x, ln2)
        elif "mlp" in sites:
            h = fused_ln_gemm(x, ln2.weight, ln2.bias, mlp.p0.weight,
                              mlp.p0.bias, activation="sqrelu", eps=ln2.eps)
            h = F.linear(h, mlp.p1.weight.to(h.dtype))
            if mlp.p1.bias is not None:
                h = h + mlp.p1.bias.to(self.dtype)
            x = x + h
        else:
            x = x + mlp(ln2(x))
        return x, k_new, v_new, new_shift


@torch.no_grad()
def reset_prior_parameters(module: nn.Module, generator: torch.Generator,
                           uniform_positions: bool = False) -> None:
    """Random weights of a prior drawn on its device from ``generator``, in
    the order of ``named_parameters``: normal (std 0.02) GEMM kernels and
    token embeddings, zero biases, unit LayerNorm weights, the
    ``time_mix`` ramp i / (C - 1), and position embeddings zero or, with
    ``uniform_positions``, uniform in [0, 1) (the RQ prior's, as the JAX
    module draws them)."""
    norms = {id(m.weight) for m in module.modules()
             if isinstance(m, LayerNorm)}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("pos_emb_"):
            if uniform_positions:
                p.uniform_(0.0, 1.0, generator=generator)
            else:
                p.zero_()
        elif leaf == "bias":
            p.zero_()
        elif id(p) in norms:
            p.fill_(1.0)
        elif leaf == "time_mix":
            c = p.shape[-1]
            p.copy_((torch.arange(c, dtype=torch.float32) / max(c - 1, 1))
                    .reshape(p.shape))
        else:  # GEMM kernels and token embeddings
            p.normal_(0.0, 0.02, generator=generator)


def code_position(pos_emb_code: nn.Parameter, step) -> torch.Tensor:
    """The position embedding of code position ``step - 1`` as a (1, 1, C)
    row, or (B, 1, C) rows for a (B,) tensor of per-row steps."""
    if isinstance(step, int):
        return pos_emb_code[0, step - 1][None, None, :]
    return pos_emb_code[0][step.long() - 1][:, None, :]


def init_stacked_cache(layers: int, batch: int, ctx_len: int, width: int,
                       dtype: torch.dtype, kv_int8: bool,
                       device: torch.device, ctx_multiple: int = 8
                       ) -> Dict[str, torch.Tensor]:
    """The decode cache of a stack of ``layers`` Blocks (GPT.init_cache):
    zeroed (L, B, ctx, C) k and v stacks, ctx padded to a multiple of
    ``ctx_multiple``, and the (L, B, C) token-shift state in ``dtype``;
    with ``kv_int8`` int8 stacks and their (L, B, ctx) fp32 ``k_scale`` /
    ``v_scale``."""
    ctx_pad = -(-ctx_len // ctx_multiple) * ctx_multiple
    shape = (layers, batch, ctx_pad, width)
    kv_dtype = torch.int8 if kv_int8 else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "shift": torch.zeros((layers, batch, width), dtype=dtype,
                             device=device),
    }
    if kv_int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    return cache


def prefill_stack(blocks, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  kv_int8: bool, dtype: torch.dtype) -> torch.Tensor:
    """Run the T-token prefix x (B, T, C) through ``blocks``, filling rows
    [0, T) of each layer's k and v and the shift state of ``cache`` in
    place; returns the last block's output. Beside an int8 cache the rows
    are quantised per row from ``dtype``, as the JAX package quantises its
    prefix-sized temporary; else cast to the cache's dtype."""
    t = x.shape[1]
    shifts = []
    for i, block in enumerate(blocks):
        x, s, k, v = block.prefill(x)
        for name, rows in (("k", k), ("v", v)):
            if kv_int8:
                q, sc = quantize_channelwise(rows.to(dtype))
                cache[name][i][:, :t] = q
                cache[name + "_scale"][i][:, :t] = sc
            else:
                cache[name][i][:, :t] = rows
        shifts.append(s)
    cache["shift"] = torch.stack(shifts).to(cache["shift"].dtype)
    return x


def decode_stack(blocks, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cur_len, sites: frozenset) -> torch.Tensor:
    """One token x (B, 1, C) through ``blocks`` at position ``cur_len`` (an
    int, or a (B,) tensor of per-row positions): the stacked caches are
    read-only inside the layer loop; after the last layer the new rows go
    in with one in-place row write per stack (B10), quantised with their
    scales beside an int8 cache, and the shift state is replaced. Returns
    the last block's output. The decode step of GPT and the spatial step
    of RQTransformer."""
    k_all, v_all = cache["k"], cache["v"]
    ks, vs = cache.get("k_scale"), cache.get("v_scale")
    k_cols, v_cols, s_cols = [], [], []
    for i, block in enumerate(blocks):
        x, k, v, s = block.decode(x, k_all, v_all, cur_len,
                                  cache["shift"][i], i, ks, vs, sites)
        k_cols.append(k)
        v_cols.append(v)
        s_cols.append(s)
    cache["shift"] = torch.stack(s_cols).to(cache["shift"].dtype)
    k_news, v_news = torch.stack(k_cols), torch.stack(v_cols)
    if ks is not None:
        k_news, k_sc = quantize_channelwise(k_news)
        v_news, v_sc = quantize_channelwise(v_news)
        scale_row_update(ks, k_sc, cur_len)
        scale_row_update(vs, v_sc, cur_len)
    cache_row_update(k_all, k_news, cur_len)
    cache_row_update(v_all, v_news, cur_len)
    return x


class GPT(nn.Module):
    """Class-conditional GPT prior over tokenizer codes.

    ``kv_int8``: the sampling cache is int8 with per-row fp32 scales
    (halves the cache bytes a decode step reads); it composes with the
    weights-only int8 of ``quantize_decode_params``.

    ``device`` defaults to ``cuda``; ``dtype`` is the compute dtype
    (``"float32"`` or ``"bfloat16"``), in which the GEMM weights are also
    stored; the embeddings, LayerNorms, position embeddings and
    ``time_mix`` are fp32, as the JAX module reads them. Training keeps the
    GEMM weights in fp32 (:func:`fp32_master_weights`). Random weights are
    drawn on ``device`` from ``torch.Generator(device).manual_seed(seed)``:
    normal (std 0.02) GEMM kernels and token embeddings, zero biases and
    position embeddings, the ``time_mix`` ramp i / (C - 1).
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
        if act_int8:
            raise NotImplementedError(
                "act_int8 (W8A8: int8 activations on int8 GEMMs) is not "
                "ported; weights-only int8 (quantize_decode_params) and "
                "kv_int8 are (ROADMAP A8)")
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
        self.kv_int8 = kv_int8
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
        for block in self.blocks:  # before the draws, which write through
            block.attn.fused_qkv("weight")
            block.attn.fused_qkv("bias")
        reset_prior_parameters(self,
                               torch.Generator(self.device).manual_seed(seed))
        self.eval()

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
        of 8, and the (L, B, C) token-shift state, in the compute dtype;
        with ``kv_int8`` the stacks are int8 and (L, B, ctx) fp32
        ``k_scale`` / ``v_scale`` ride beside them. (The JAX package pads
        an int8 cache to a multiple of 128 for its kernel's scale blocks;
        the port's kernels need no more than 8.)"""
        return init_stacked_cache(self.n_layers, batch, self.ctx_len,
                                  self.embed_dim,
                                  self.dtype if dtype is None else dtype,
                                  self.kv_int8, self.device)

    def _head(self, x: torch.Tensor, sites: frozenset) -> torch.Tensor:
        """Final LayerNorm + vocab head of (B, C) rows: B13 over the int8
        twin, B1 at the LNFUSE head site, else LayerNorm then the GEMM."""
        ln, head = self.layer_norm, self.head
        if head.weight_q is not None:
            return int8_ln_gemm(x, ln.weight, ln.bias, None, None,
                                head.weight_q, head.scale, None,
                                eps=ln.eps)[0]
        if "head" in sites:
            return fused_ln_gemm(x, ln.weight, ln.bias, head.weight, None,
                                 eps=ln.eps)
        return head(ln(x))

    def prefill(self, conds: torch.Tensor, cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the condition prefix, filling cache rows [0, cond_num_tokens)
        in place; returns the logits for code token 0 and the cache."""
        conds = conds.reshape(conds.shape[0], -1)
        x = self.tok_emb_cond(conds) + self.pos_emb_cond.to(self.dtype)
        x = prefill_stack(self.blocks, x, cache, self.kv_int8, self.dtype)
        return self._head(x[:, self.cond_num_tokens - 1], frozenset()), cache

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
        sites = lnfuse_sites()
        pos = code_position(self.pos_emb_code, step)
        x = self.tok_emb_code(token)[:, None, :] + pos.to(self.dtype)
        cur_len = self.cond_num_tokens + step - 1
        x = decode_stack(self.blocks, x, cache, cur_len, sites)
        return self._head(x[:, -1], sites), cache


class RQTransformer(nn.Module):
    """Two-axis autoregressive prior over residual-quantizer codes: the
    counterpart of ``RQTransformer`` of the JAX package
    (``enhancing_tpu/models/stage2/layers.py:779-1052``).

    A spatial stack (``spatial_{i}``, prefix-causal over the condition
    tokens and the depth-summed code embeddings of the positions) gives one
    hidden a position; a depth stack (``depth_{i}``, causal, no condition)
    autoregresses over the depth prefix sums of the codes at that
    position, from the hidden. ``forward`` is the teacher-forced pass,
    (B * T, D, V) logits; sampling runs ``spatial_prefill``, then at each
    position ``spatial_step`` (the GPT's stacked decode: B9 a layer, two
    B10 row writes) and ``depth_forward`` once a depth (the depth window
    recomputed, masked past ``d``; at fewer than 8 tokens and a head dim
    no kernel takes, the attention's short route,
    ``ops.attention.attention_bnhd_route``).

    ``device``, ``dtype`` and the weights as for :class:`GPT`: GEMM
    weights stored in the compute dtype, embeddings, position embeddings,
    LayerNorms and ``time_mix`` fp32; random weights drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)``, the position
    embeddings uniform in [0, 1) as the JAX module draws them. Training
    keeps the GEMM weights in fp32 (:func:`fp32_master_weights`).

    Int8 serving, as for :class:`GPT`: ``kv_int8`` makes the spatial cache
    int8 with per-row fp32 scales (its ctx padded to a multiple of 128, as
    the JAX module pads it); the int8 twins of ``quantize_decode_params``
    run the spatial prefill (B12, B14) and the spatial steps (B13, B12,
    B14). The depth stack and the head read the full-precision weights,
    as the JAX module's ``depth_forward`` does. ``act_int8`` (ROADMAP A8)
    and ``sp_mesh`` (A9) raise.
    """

    def __init__(self, vocab_cond_size: int, vocab_img_size: int,
                 embed_dim: int, cond_num_tokens: int, img_num_tokens: int,
                 depth_num_tokens: int, spatial_n_heads: int,
                 depth_n_heads: int, spatial_n_layers: int,
                 depth_n_layers: int, mlp_bias: bool = True,
                 attn_bias: bool = True, dtype: str = "float32",
                 scan_layers: bool = True, remat: bool = False,
                 kv_int8: bool = False, act_int8: bool = False,
                 sp_mesh=None, *,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0) -> None:
        super().__init__()
        if act_int8:
            raise NotImplementedError(
                "act_int8 (W8A8: int8 activations on int8 GEMMs) is not "
                "ported (ROADMAP A8)")
        if sp_mesh is not None:
            raise NotImplementedError(
                "sp_mesh: multi-GPU parallelism is a later slice of the "
                "port (ROADMAP A9)")
        self.vocab_cond_size = vocab_cond_size
        self.vocab_img_size = vocab_img_size
        self.embed_dim = embed_dim
        self.cond_num_tokens = cond_num_tokens
        self.img_num_tokens = img_num_tokens
        self.depth_num_tokens = depth_num_tokens
        self.spatial_n_layers = spatial_n_layers
        self.depth_n_layers = depth_n_layers
        self.dtype = _dtype(dtype)
        self.kv_int8 = kv_int8
        self.device = resolve_device(device)
        with torch.device("meta"):
            self.tok_emb_cond = nn.Embedding(vocab_cond_size, embed_dim)
            self.pos_emb_cond = nn.Parameter(
                torch.empty(1, cond_num_tokens, embed_dim))
            self.tok_emb_code = nn.Embedding(vocab_img_size, embed_dim)
            self.pos_emb_code = nn.Parameter(
                torch.empty(1, img_num_tokens, embed_dim))
            self.pos_emb_depth = nn.Parameter(
                torch.empty(1, depth_num_tokens - 1, embed_dim))
            for i in range(spatial_n_layers):
                self.add_module(f"spatial_{i}", Block(
                    embed_dim, spatial_n_heads, cond_num_tokens, mlp_bias,
                    attn_bias, dtype=self.dtype))
            for i in range(depth_n_layers):
                self.add_module(f"depth_{i}", Block(
                    embed_dim, depth_n_heads, 0, mlp_bias, attn_bias,
                    dtype=self.dtype))
            self.ln_spatial = LayerNorm(embed_dim, dtype=self.dtype)
            self.ln_depth = LayerNorm(embed_dim, dtype=self.dtype)
            self.head = _dense(embed_dim, vocab_img_size, False, self.dtype)
        self.to_empty(device=self.device)
        for block in self.blocks:
            block.attn.fused_qkv("weight")
            block.attn.fused_qkv("bias")
        reset_prior_parameters(
            self, torch.Generator(self.device).manual_seed(seed),
            uniform_positions=True)
        self.eval()

    @property
    def ctx_len(self) -> int:
        return self.cond_num_tokens + self.img_num_tokens

    @property
    def spatial_blocks(self):
        return [getattr(self, f"spatial_{i}")
                for i in range(self.spatial_n_layers)]

    @property
    def depth_blocks(self):
        return [getattr(self, f"depth_{i}")
                for i in range(self.depth_n_layers)]

    @property
    def blocks(self):
        """Every Block: the spatial stack's, then the depth stack's."""
        return self.spatial_blocks + self.depth_blocks

    def _depth(self, v: torch.Tensor) -> torch.Tensor:
        for block in self.depth_blocks:
            v = block(v)
        return self.ln_depth(v)

    def forward(self, codes: torch.Tensor,
                conds: torch.Tensor) -> torch.Tensor:
        """codes (B, T, D), conds (B, cond_num_tokens) ints -> logits
        (B * T, D, vocab_img_size): depth d of position t predicts code
        (t, d) from the condition, the positions < t and the depths < d of
        position t (the depth-axis cumsum of the code embeddings; the JAX
        package's PARITY.md)."""
        b = codes.shape[0]
        codes = codes.reshape(b, -1, codes.shape[-1])
        emb = self.tok_emb_code(codes)                       # (B, T, D, C)
        conds = conds.reshape(b, -1)
        cc = self.tok_emb_cond(conds) + self.pos_emb_cond.to(self.dtype)
        csum = torch.cumsum(emb, dim=-2)
        h = torch.cat([cc, csum[..., -1, :]
                       + self.pos_emb_code.to(self.dtype)], dim=1)
        for block in self.spatial_blocks:
            h = block(h)
        h = self.ln_spatial(h)[:, self.cond_num_tokens - 1:-1]  # (B, T, C)
        v = csum[..., :-1, :] + self.pos_emb_depth.to(self.dtype)
        v = torch.cat([h[:, :, None, :].to(v.dtype), v], dim=2)
        v = v.reshape(-1, *v.shape[2:])                      # (B * T, D, C)
        return self.head(self._depth(v))

    # -- cached sampling ------------------------------------------------------

    def init_cache(self, batch: int, dtype: torch.dtype | None = None
                   ) -> Dict[str, torch.Tensor]:
        """The spatial stack's cache (:meth:`GPT.init_cache`); the depth
        stack keeps none. With ``kv_int8`` ctx is padded to a multiple of
        128, as the JAX module pads it (1025 -> 1152)."""
        return init_stacked_cache(self.spatial_n_layers, batch, self.ctx_len,
                                  self.embed_dim,
                                  self.dtype if dtype is None else dtype,
                                  self.kv_int8, self.device,
                                  128 if self.kv_int8 else 8)

    def spatial_prefill(self, conds: torch.Tensor,
                        cache: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The condition prefix through the spatial stack, filling cache
        rows [0, cond_num_tokens) in place (quantised per row beside an
        int8 cache); returns the (B, C) hidden of code position 0 and the
        cache."""
        conds = conds.reshape(conds.shape[0], -1)
        x = self.tok_emb_cond(conds) + self.pos_emb_cond.to(self.dtype)
        x = prefill_stack(self.spatial_blocks, x, cache, self.kv_int8,
                          self.dtype)
        return self.ln_spatial(x)[:, self.cond_num_tokens - 1], cache

    def spatial_step(self, prev_codes: torch.Tensor, step,
                     cache: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """prev_codes: (B, D) codes of position step - 1 (step >= 1); step
        an int or a (B,) tensor of per-row positions. Returns the (B, C)
        hidden of position ``step`` and the cache, updated in place (the
        new rows quantised per row beside an int8 cache)."""
        pos = code_position(self.pos_emb_code, step)
        x = (torch.sum(self.tok_emb_code(prev_codes), dim=1, keepdim=True)
             + pos.to(self.dtype))
        x = decode_stack(self.spatial_blocks, x, cache,
                         self.cond_num_tokens + step - 1, lnfuse_sites())
        return self.ln_spatial(x)[:, -1], cache

    def depth_forward(self, hidden: torch.Tensor, depth_codes: torch.Tensor,
                      d: int) -> torch.Tensor:
        """Logits (B, V) of depth ``d`` at one position: hidden (B, C) from
        the spatial stack, depth_codes (B, D) of which the first ``d`` are
        valid. The depth window is recomputed with the codes at depths >= d
        masked out of the cumsum (the window is tiny: no cache)."""
        dmax = self.depth_num_tokens
        emb = self.tok_emb_code(depth_codes)                 # (B, D, C)
        valid = torch.arange(dmax, device=emb.device)[None, :, None] < d
        csum = torch.cumsum(torch.where(valid, emb, torch.zeros_like(emb)),
                            dim=1)
        pos_d = F.pad(self.pos_emb_depth[0], (0, 0, 0, 1))   # (D, C)
        v = csum[:, :-1] + pos_d[None, :-1]
        v = torch.cat([hidden[:, None, :].to(v.dtype), v], dim=1)
        return self.head(self._depth(v)[:, d])


def fp32_master_weights(prior: Union[GPT, RQTransformer]
                        ) -> Union[GPT, RQTransformer]:
    """Store every GEMM weight and bias of ``prior`` (a GPT or an
    RQTransformer) in fp32, cast to the compute dtype at each use, as flax
    keeps its parameters: the master weights that training updates. Each
    block's q/k/v parameters stay row blocks of one fused tensor
    (``MultiHeadSelfAttention.fused_qkv``), so an optimizer's in-place
    updates reach the fused qkv product too. A prior stored in fp32
    already is left as it is; any other module raises TypeError before a
    weight is touched. Returns ``prior``."""
    if not isinstance(prior, (GPT, RQTransformer)):
        raise TypeError(f"a prior is a GPT or an RQTransformer, got "
                        f"{type(prior).__name__}")
    with torch.no_grad():
        for module in prior.modules():
            if not isinstance(module, Dense):
                continue
            for attr in ("weight", "bias"):
                p = getattr(module, attr)
                if p is not None and p.dtype != torch.float32:
                    setattr(module, attr, nn.Parameter(
                        p.float(), requires_grad=p.requires_grad))
        for block in prior.blocks:
            block.attn.fused_qkv("weight")
            block.attn.fused_qkv("bias")
    return prior
