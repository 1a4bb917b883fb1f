from .discriminator import (
    ActNorm,
    ConvLayer,
    EqualConv2d,
    EqualLinear,
    PatchDiscriminator,
    StyleBlock,
    StyleDiscriminator,
    minibatch_stddev,
)
from .gan import GAN_LOSSES, hinge_d_loss, least_square_d_loss, vanilla_d_loss
from .lpips import LPIPS, VGG16Features, init_lpips, load_torch_lpips
from .segmentation import BCELoss, BCELossWithQuant
from .vqperceptual import DummyLoss, VQLPIPS, VQLPIPSWithDiscriminator

__all__ = [
    "StyleDiscriminator", "PatchDiscriminator", "ActNorm", "ConvLayer",
    "EqualConv2d", "EqualLinear", "StyleBlock", "minibatch_stddev",
    "hinge_d_loss", "vanilla_d_loss", "least_square_d_loss", "GAN_LOSSES",
    "LPIPS", "VGG16Features", "init_lpips", "load_torch_lpips",
    "BCELoss", "BCELossWithQuant",
    "DummyLoss", "VQLPIPS", "VQLPIPSWithDiscriminator",
]
