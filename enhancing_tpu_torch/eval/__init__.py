from .inception import InceptionV3Pool3, fid_feature_fn, init_inception
from .metrics import FrechetDistance, codebook_usage, psnr, ssim, vgg_feature_fn

__all__ = ["psnr", "ssim", "FrechetDistance", "codebook_usage",
           "vgg_feature_fn", "InceptionV3Pool3", "init_inception",
           "fid_feature_fn"]
