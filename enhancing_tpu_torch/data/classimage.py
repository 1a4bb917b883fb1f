"""Generic ImageFolder dataset: root/<split>/<class_name>/<image files>.

The port's copy of ``enhancing_tpu/data/classimage.py``. Returns
{'image': float HWC, 'class': int}; ``get_batch`` is the loader's
whole-batch path through the native decode pipeline (:mod:`.native`).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .base import Dataset
from .transforms import (IMG_EXTENSIONS, EvalTransform, TrainTransform,
                         load_image)


def scan_image_folder(root: Path) -> Tuple[List[Tuple[str, int]], List[str]]:
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for dirpath, _, files in os.walk(root / c):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTENSIONS):
                    samples.append((str(Path(dirpath) / f), class_to_idx[c]))
    return samples, classes


class ClassImageBase(Dataset):
    split = "train"
    train = True

    def __init__(self, root: str, resolution: int = 256,
                 split: Optional[str] = None) -> None:
        self.root = Path(root)
        split = split or self.split
        folder = self.root / split if (self.root / split).is_dir() else self.root
        self.samples, self.classes = scan_image_folder(folder)
        self.transform = (TrainTransform(resolution) if self.train
                          else EvalTransform(resolution))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, cls = self.samples[idx]
        img = self.transform(load_image(path))
        return {"image": img, "class": np.int32(cls)}

    def get_batch(self, indices):
        """Whole-batch fast path for the DataLoader: the native C++ pipeline
        (decode -> shorter-side resize -> crop -> flip -> normalize,
        native/image_ops.cpp thread pool) replaces per-sample PIL work.
        Matches TrainTransform/EvalTransform semantics; undecodable files
        (webp, corrupt) fall back to the per-sample path."""
        import random as _random

        from . import native

        if not native.has_decoders():
            from .base import _stack
            return _stack([self[j] for j in indices])

        res = self.transform.resolution
        blobs, tops, lefts, flips, classes = [], [], [], [], []
        fallback = {}
        for pos, j in enumerate(indices):
            path, cls = self.samples[j]
            classes.append(cls)
            with open(path, "rb") as f:
                data = f.read()
            dims = native.decode_dims(data)
            if dims is None:
                fallback[pos] = j
                blobs.append(b"")
                tops.append(0)
                lefts.append(0)
                flips.append(0)
                continue
            h, w = dims
            short = min(h, w)
            if short < h:
                sh, sw = max(1, round(h * res / short)), res
            else:
                sh, sw = res, max(1, round(w * res / short))
            if self.train:
                tops.append(_random.randint(0, max(0, sh - res)))
                lefts.append(_random.randint(0, max(0, sw - res)))
                flips.append(int(_random.random() < 0.5))
            else:
                tops.append(max(0, (sh - res) // 2))
                lefts.append(max(0, (sw - res) // 2))
                flips.append(0)
            blobs.append(data)

        images, ok = native.decode_pipeline_batch(blobs, res, res, tops,
                                                  lefts, flips)
        for pos in list(fallback) + [p for p, o in enumerate(ok) if not o]:
            images[pos] = self[indices[pos]]["image"]
        return {"image": images,
                "class": np.asarray(classes, np.int32)}


class ClassImageTrain(ClassImageBase):
    split, train = "train", True


class ClassImageValidation(ClassImageBase):
    split, train = "val", False
