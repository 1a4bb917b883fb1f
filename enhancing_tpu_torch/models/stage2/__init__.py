from .layers import FFN, GPT, Block, MultiHeadSelfAttention
from .quantize import drop_quantized_kernels, quantize_decode_params
from .sampling import filter_logits, sample_gpt
from .transformer import CondTransformer

__all__ = ["GPT", "Block", "FFN", "MultiHeadSelfAttention", "CondTransformer",
           "sample_gpt", "filter_logits", "quantize_decode_params",
           "drop_quantized_kernels"]
