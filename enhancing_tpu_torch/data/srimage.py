"""Super-resolution pairs: HR crop + bicubic-downscaled LR.

The port's copy of ``enhancing_tpu/data/srimage.py``. Returns {'low
resolution', 'high resolution'} float HWC pairs; corrupt files skip to a
neighbour sample.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .base import Dataset
from .transforms import (
    IMG_EXTENSIONS,
    center_crop,
    load_image,
    random_crop,
    random_hflip,
    resize,
    resize_exact,
    to_float,
)


class SRImageBase(Dataset):
    train = True

    def __init__(self, root: str, resolution: int = 256,
                 downscale: int = 4) -> None:
        self.root = Path(root)
        self.resolution = resolution
        self.downscale = downscale
        self.files = sorted(p for p in self.root.glob("**/*")
                            if p.suffix.lower() in IMG_EXTENSIONS)

    def __len__(self) -> int:
        return len(self.files)

    def _skip_sample(self, idx: int):
        return self[(idx + 1) % len(self)]

    def __getitem__(self, idx: int):
        try:
            img = load_image(str(self.files[idx]))
        except (OSError, ValueError):
            return self._skip_sample(idx)

        r = self.resolution
        h, w = img.shape[:2]
        if min(h, w) < r:
            img = resize(img, r)
        if self.train:
            hr = random_hflip(random_crop(img, r))
        else:
            hr = center_crop(img, r)
        lr = resize_exact(hr, (r // self.downscale, r // self.downscale))
        return {"high resolution": to_float(np.ascontiguousarray(hr)),
                "low resolution": to_float(np.ascontiguousarray(lr))}


class SRImageTrain(SRImageBase):
    train = True


class SRImageValidation(SRImageBase):
    train = False
