from .layers import (FFN, GPT, Block, MultiHeadSelfAttention, RQTransformer,
                     fp32_master_weights)
from .quantize import drop_quantized_kernels, quantize_decode_params
from .sampling import filter_logits, sample_gpt, sample_rq
from .transformer import CondTransformer

__all__ = ["GPT", "RQTransformer", "Block", "FFN", "MultiHeadSelfAttention",
           "CondTransformer", "sample_gpt", "sample_rq", "filter_logits",
           "quantize_decode_params", "drop_quantized_kernels",
           "fp32_master_weights"]
