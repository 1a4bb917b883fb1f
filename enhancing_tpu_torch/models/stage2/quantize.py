"""Weights-only int8 serving of the stage-2 priors.

Counterpart of ``enhancing_tpu/models/stage2/quantize.py``:

- :func:`quantize_decode_params` gives every GEMM of the prior (a GPT or
  an RQTransformer, as JAX's ``_walk`` gives every Dense ``kernel`` of the
  tree) an int8 twin, ``weight_q`` (int8, (out, in), ``nn.Linear``'s
  layout) and ``scale`` (fp32, (out,)), buffers on the port's ``Dense``
  (``ops.int8.quantize_channelwise``). The GPT's decode step, prefill and
  vocab head, and the RQ prior's spatial prefill and spatial steps, then
  read the int8 copies (``models/stage2/layers.py``): a decode step, bound
  by its weight reads, reads half the bytes. The RQ prior's depth stack
  and head keep reading the full-precision weights, as in JAX. One tensor
  is quantised at a time, on the device, so the only transient is one
  GEMM's fp32 copy.
- :func:`drop_quantized_kernels` frees the full-precision weights that
  have a twin (the JAX package keeps ``(..., 1, 1)`` placeholders for
  ``nn.scan``; the port sets them to None). After it the full forward
  raises; sampling is unchanged. It refuses an RQ prior, whose depth
  stack samples on the full-precision weights, as the JAX function does.

Layout: the query, key and value twins of a block are views of one
(3C, C) int8 buffer and one (3C,) scale buffer on the attention module
(``qkv_q``, ``qkv_scale``), as its full-precision weights and biases are
views of one tensor (``MultiHeadSelfAttention.fused_qkv``), so the fused
qkv product of the decode step and the prefill reads them with no
concatenation at run time. The twins are a snapshot: quantise again after
loading new weights.
"""
from __future__ import annotations

from typing import Any, Union

import torch

from ...ops.int8 import quantize_channelwise
from ..stage1.layers import Dense
from .layers import GPT, MultiHeadSelfAttention, RQTransformer

Prior = Union[GPT, RQTransformer]


def _prior(model: Any) -> Prior:
    prior = getattr(model, "transformer", model)
    if not isinstance(prior, (GPT, RQTransformer)):
        raise ValueError(
            f"int8 serving takes the GPT prior or the RQ prior "
            f"(RQTransformer), got {type(prior).__name__}")
    return prior


def _set_twin(dense: Dense, weight_q: torch.Tensor,
              scale: torch.Tensor) -> None:
    dense.weight_q = weight_q
    dense.scale = scale


def attach_int8_buffers(model: Any) -> Prior:
    """Allocate (uninitialised) int8 twins for every GEMM of the prior that
    has none yet: the layout above. Returns the prior."""
    prior = _prior(model)
    for attn in prior.modules():
        if not isinstance(attn, MultiHeadSelfAttention) or \
                attn.qkv_q is not None:
            continue
        c, dev = attn.embed_dim, attn.query.weight.device
        attn.qkv_q = torch.empty((3 * c, c), dtype=torch.int8, device=dev)
        attn.qkv_scale = torch.empty(3 * c, dtype=torch.float32, device=dev)
        for i, dense in enumerate((attn.query, attn.key, attn.value)):
            _set_twin(dense, attn.qkv_q[i * c:(i + 1) * c],
                      attn.qkv_scale[i * c:(i + 1) * c])
    for dense in prior.modules():
        if isinstance(dense, Dense) and dense.weight_q is None:
            _set_twin(dense, torch.empty(dense.weight.shape, dtype=torch.int8,
                                         device=dense.weight.device),
                      torch.empty(dense.out_features, dtype=torch.float32,
                                  device=dense.weight.device))
    return prior


@torch.no_grad()
def quantize_decode_params(model: Any) -> Any:
    """Give every GEMM of the prior (a GPT, an RQTransformer or a
    CondTransformer's prior) its int8 twin, quantised from the current
    weights; returns ``model``."""
    prior = attach_int8_buffers(model)
    for dense in prior.modules():
        if isinstance(dense, Dense):
            if dense.weight is None:
                raise ValueError("a dropped weight cannot be quantised "
                                 "again")
            w_q, scale = quantize_channelwise(dense.weight)
            dense.weight_q.copy_(w_q)
            dense.scale.copy_(scale)
            del w_q, scale
    return model


def drop_quantized_kernels(model: Any) -> int:
    """Free every full-precision GEMM weight of the GPT prior that has an
    int8 twin (every GEMM after :func:`quantize_decode_params`); returns
    the bytes freed. Sampling (``prefill``, ``decode_step``) reads only the
    twins; the full forward raises afterwards. An RQ prior raises
    ValueError before anything is freed: its depth stack samples by full
    recompute on the full-precision weights (``depth_forward``), so
    dropping them would give wrong logits, not save memory."""
    gpt = _prior(model)
    if isinstance(gpt, RQTransformer):
        raise ValueError(
            "drop_quantized_kernels is not valid for RQTransformer: the "
            "depth stack's sampling path (depth_forward) reads the "
            "full-precision weights directly, so dropping them would "
            "produce wrong logits, not save memory. Serve the RQ prior "
            "with quantize_decode_params alone.")
    freed = 0
    for dense in gpt.modules():
        if isinstance(dense, Dense) and dense.weight_q is not None and \
                dense.weight is not None:
            freed += dense.weight.numel() * dense.weight.element_size()
            dense.weight = None
    for attn in gpt.modules():  # the tensor the q/k/v weights were views of
        if isinstance(attn, MultiHeadSelfAttention):
            attn.qkv_tied.pop("weight", None)
    return freed


__all__ = ["quantize_decode_params", "drop_quantized_kernels",
           "attach_int8_buffers"]
