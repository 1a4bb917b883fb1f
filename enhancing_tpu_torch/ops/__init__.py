from .attention import multihead_attention_packed_qkv
from .common import LAUNCHES, reset_launches
from .ln_gemm import fused_layernorm, fused_ln_gemm, layernorm
from .vq import codebook_distances, l2_normalize, nearest_codebook_indices

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "multihead_attention_packed_qkv",
    "fused_ln_gemm",
    "fused_layernorm",
    "layernorm",
    "nearest_codebook_indices",
    "codebook_distances",
    "l2_normalize",
]
