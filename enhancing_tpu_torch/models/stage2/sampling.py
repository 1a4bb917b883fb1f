"""Autoregressive sampling of the stage-2 priors, on the device.

Counterpart of ``filter_logits``, ``_draw``, ``sample_gpt`` and
``sample_rq`` of ``enhancing_tpu/models/stage2/sampling.py``. The JAX
package compiles the decode into one ``lax.scan``; here it is a Python
loop over the steps of eager calls: one prefill, then ``img_num_tokens -
1`` KV-cache decode steps, each drawing one token (the GPT prior), or
each position's spatial step followed by a depth loop of
``depth_num_tokens`` draws (the RQ prior). Top-k, top-p and the
categorical draw stay on the device and the loop never waits for the
host. The draw takes an explicit ``torch.Generator`` on the model's
device; it gives other numbers than ``jax.random`` for the same seed (the
same distribution: a Gumbel-max draw, as ``jax.random.categorical``
makes).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .layers import GPT, RQTransformer


def filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k, then nucleus (top-p) filtering of (B, V) logits: top-k keeps
    the k best logits; top-p keeps the smallest prefix of the descending
    distribution whose cumulative probability reaches ``top_p`` (the first
    token always kept). Filtered entries become -inf."""
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if top_k is not None:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # remove tokens once the cumulative probability before them passed
        # top_p; the threshold is the smallest kept logit
        kept = torch.where(cum - probs >= top_p, neg_inf, sorted_logits)
        threshold = torch.where(torch.isfinite(kept), kept,
                                torch.full_like(kept, float("inf"))).amin(
                                    dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, neg_inf, logits)
    return logits


def _draw(generator: torch.Generator, logits: torch.Tensor,
          temperature: float, top_k: Optional[int],
          top_p: Optional[float]) -> torch.Tensor:
    """One categorical draw per row: fp32 logits over the temperature,
    filtered, then argmax(logits + Gumbel noise)."""
    logits = filter_logits(logits.float() / temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


@torch.inference_mode()
def sample_gpt(module: GPT, conds: torch.Tensor, generator: torch.Generator,
               *, top_k: Optional[int] = None, top_p: Optional[float] = None,
               temperature: float = 1.0, with_logits: bool = True
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Sample ``img_num_tokens`` codes from a GPT prior.

    conds: (B, cond_num_tokens) ints on the model's device. Returns
    (logits (B, T, V) fp32, codes (B, T) int32); ``with_logits=False``
    returns (None, codes) and keeps no per-step logits. The GEMM weights
    are stored in the compute dtype, so no step casts them.
    """
    b, t = conds.shape[0], module.img_num_tokens
    logits_all = (torch.empty((b, t, module.vocab_img_size),
                              dtype=torch.float32, device=conds.device)
                  if with_logits else None)
    cache = module.init_cache(b)
    logits, cache = module.prefill(conds, cache)
    tok = _draw(generator, logits, temperature, top_k, top_p)
    toks = [tok]
    if with_logits:
        logits_all[:, 0] = logits
    for step in range(1, t):
        logits, cache = module.decode_step(tok, step, cache)
        tok = _draw(generator, logits, temperature, top_k, top_p)
        toks.append(tok)
        if with_logits:
            logits_all[:, step] = logits
    return logits_all, torch.stack(toks, dim=1)


@torch.inference_mode()
def sample_rq(module: RQTransformer, conds: torch.Tensor,
              generator: torch.Generator, *, top_k: Optional[int] = None,
              top_p: Optional[float] = None, temperature: float = 1.0,
              with_logits: bool = True
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Sample (B, T, D) residual codes from an RQ prior.

    conds: (B, cond_num_tokens) ints on the model's device. The spatial
    prefill gives position 0's hidden; at every position a depth loop
    draws depths 0..D-1 (``depth_forward`` on the codes drawn so far),
    then the spatial step takes that position's codes to the next
    position's hidden. Returns (logits (B * T, D, V) fp32, codes (B, T, D)
    int32); ``with_logits=False`` returns (None, codes).
    """
    b, t = conds.shape[0], module.img_num_tokens
    dmax, v = module.depth_num_tokens, module.vocab_img_size
    logits_all = (torch.empty((b, t, dmax, v), dtype=torch.float32,
                              device=conds.device)
                  if with_logits else None)
    codes_all = torch.empty((b, t, dmax), dtype=torch.int32,
                            device=conds.device)
    cache = module.init_cache(b)
    hidden, cache = module.spatial_prefill(conds, cache)
    for step in range(t):
        if step:
            hidden, cache = module.spatial_step(codes_all[:, step - 1], step,
                                                cache)
        codes = codes_all[:, step]
        codes.zero_()
        for d in range(dmax):
            logits = module.depth_forward(hidden, codes, d)
            codes[:, d] = _draw(generator, logits, temperature, top_k, top_p)
            if with_logits:
                logits_all[:, step, d] = logits
    if not with_logits:
        return None, codes_all
    return logits_all.reshape(b * t, dmax, v), codes_all
