"""Synthetic dataset for tests and card runs; the port's copy of
``enhancing_tpu/data/fake.py``."""
from __future__ import annotations

import numpy as np

from .base import Dataset


class FakeImages(Dataset):
    """Deterministic random {'image', 'class'} samples."""

    def __init__(self, length: int = 64, resolution: int = 256,
                 num_classes: int = 1000, seed: int = 0,
                 smooth: bool = True) -> None:
        self.length = length
        self.resolution = resolution
        self.num_classes = num_classes
        self.seed = seed
        self.smooth = smooth

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        r = self.resolution
        if self.smooth:
            low = rng.random((r // 8, r // 8, 3), np.float32)
            img = np.repeat(np.repeat(low, 8, axis=0), 8, axis=1)
        else:
            img = rng.random((r, r, 3), np.float32)
        return {"image": img.astype(np.float32),
                "class": np.int32(rng.integers(0, self.num_classes))}
