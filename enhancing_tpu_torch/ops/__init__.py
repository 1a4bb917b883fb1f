from .attention import (attention_packed_gridchunk, attention_proj_packed,
                        multihead_attention, multihead_attention_packed_qkv)
from .common import (F32_LAUNCHES, LAUNCHES, LN_GEMM_ROUTES, PLAIN_CALLS,
                     SHORT_CALLS, UNFUSED_CALLS, WIDE_LAUNCHES,
                     force_plain_ops, reset_launches)
from .ffn import fused_ffn
from .fused_act import fused_leaky_relu
from .ln_gemm import fused_layernorm, fused_ln_gemm, layernorm
from .vq import codebook_distances, l2_normalize, nearest_codebook_indices

__all__ = [
    "LAUNCHES",
    "F32_LAUNCHES",
    "WIDE_LAUNCHES",
    "LN_GEMM_ROUTES",
    "PLAIN_CALLS",
    "UNFUSED_CALLS",
    "SHORT_CALLS",
    "force_plain_ops",
    "reset_launches",
    "multihead_attention_packed_qkv",
    "multihead_attention",
    "attention_proj_packed",
    "attention_packed_gridchunk",
    "fused_ffn",
    "fused_leaky_relu",
    "fused_ln_gemm",
    "fused_layernorm",
    "layernorm",
    "nearest_codebook_indices",
    "codebook_distances",
    "l2_normalize",
]
