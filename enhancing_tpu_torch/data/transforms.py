"""Image transforms on numpy arrays (HWC uint8/float), and image decode.

The port's copy of ``enhancing_tpu/data/transforms.py``: every function
takes and returns HWC numpy arrays, and the output convention is float32
in [0, 1], channels last. :func:`load_image` decodes JPEG and PNG through
the repository's native libjpeg / libpng path (:mod:`.native`) where the
library was built with its decoders, and everything else, or everything
where it was not, through Pillow; Pillow is imported in the functions
that decode or resize.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def load_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC: natively where the library has decoders
    and reads the file, else through Pillow (webp, corrupt headers)."""
    from . import native
    if native.has_decoders():
        try:
            with open(path, "rb") as f:
                return native.decode_image(f.read())
        except ValueError:
            pass
    from PIL import Image
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """Resize the shorter side to ``size`` keeping the aspect (torchvision
    semantics), bilinear."""
    from PIL import Image
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    if (nh, nw) == (h, w):
        return img
    pil = Image.fromarray(img if img.dtype == np.uint8
                          else (img * 255).astype(np.uint8))
    return np.asarray(pil.resize((nw, nh), Image.BILINEAR))


def resize_exact(img: np.ndarray, hw: Tuple[int, int],
                 interpolation: Optional[int] = None) -> np.ndarray:
    """Resize to exactly ``hw`` = (height, width); bicubic unless a Pillow
    filter is given."""
    from PIL import Image
    pil = Image.fromarray(img if img.dtype == np.uint8
                          else (img * 255).astype(np.uint8))
    return np.asarray(pil.resize(
        (hw[1], hw[0]),
        Image.BICUBIC if interpolation is None else interpolation))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top:top + size, left:left + size]


def random_crop(img: np.ndarray, size: int,
                rng: Optional[random.Random] = None) -> np.ndarray:
    h, w = img.shape[:2]
    r = rng or random
    top = r.randint(0, max(0, h - size))
    left = r.randint(0, max(0, w - size))
    return img[top:top + size, left:left + size]


def random_hflip(img: np.ndarray, p: float = 0.5,
                 rng: Optional[random.Random] = None) -> np.ndarray:
    r = rng or random
    if r.random() < p:
        return img[:, ::-1]
    return img


def to_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return (img.astype(np.float32) / 255.0)
    return np.ascontiguousarray(img.astype(np.float32))


class TrainTransform:
    """Resize -> RandomCrop -> HFlip -> float."""

    def __init__(self, resolution: int = 256) -> None:
        self.resolution = resolution

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = resize(img, self.resolution)
        img = random_crop(img, self.resolution)
        img = random_hflip(img)
        return to_float(np.ascontiguousarray(img))


class EvalTransform:
    """Resize -> CenterCrop -> float."""

    def __init__(self, resolution: int = 256) -> None:
        self.resolution = resolution

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = resize(img, self.resolution)
        img = center_crop(img, self.resolution)
        return to_float(np.ascontiguousarray(img))
