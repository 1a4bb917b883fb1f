from .discriminator import (
    ConvLayer,
    EqualConv2d,
    EqualLinear,
    StyleBlock,
    StyleDiscriminator,
    minibatch_stddev,
)
from .gan import GAN_LOSSES, hinge_d_loss, least_square_d_loss, vanilla_d_loss
from .lpips import LPIPS, VGG16Features, init_lpips
from .vqperceptual import DummyLoss, VQLPIPS, VQLPIPSWithDiscriminator

__all__ = [
    "StyleDiscriminator", "ConvLayer", "EqualConv2d", "EqualLinear",
    "StyleBlock", "minibatch_stddev",
    "hinge_d_loss", "vanilla_d_loss", "least_square_d_loss", "GAN_LOSSES",
    "LPIPS", "VGG16Features", "init_lpips",
    "DummyLoss", "VQLPIPS", "VQLPIPSWithDiscriminator",
]
