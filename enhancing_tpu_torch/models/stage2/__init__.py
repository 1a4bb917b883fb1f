from .layers import FFN, GPT, Block, MultiHeadSelfAttention
from .sampling import filter_logits, sample_gpt
from .transformer import CondTransformer

__all__ = ["GPT", "Block", "FFN", "MultiHeadSelfAttention", "CondTransformer",
           "sample_gpt", "filter_logits"]
