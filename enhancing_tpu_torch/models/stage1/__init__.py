from .layers import ViTDecoder, ViTEncoder, get_2d_sincos_pos_embed
from .quantizers import GumbelQuantizer, VectorQuantizer
from .vitvqgan import ViTVQ, ViTVQGumbel, ViTVQModule

__all__ = ["ViTEncoder", "ViTDecoder", "get_2d_sincos_pos_embed",
           "VectorQuantizer", "GumbelQuantizer", "ViTVQ", "ViTVQGumbel",
           "ViTVQModule"]
