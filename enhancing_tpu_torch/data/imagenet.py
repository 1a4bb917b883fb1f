"""ImageNet dataset: the extracted ILSVRC2012 layout
root/{train,val}/<wnid>/*.JPEG, no torchvision or devkit needed.

The port's copy of ``enhancing_tpu/data/imagenet.py``. Returns {'image',
'class'}.
"""
from __future__ import annotations

from .classimage import ClassImageBase


class ImageNetBase(ClassImageBase):
    pass


class ImageNetTrain(ImageNetBase):
    split, train = "train", True


class ImageNetValidation(ImageNetBase):
    split, train = "val", False
