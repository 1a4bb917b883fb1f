"""Conceptual Captions (CC3M): ``<split>_list.txt`` of (image, caption).

The port's copy of ``enhancing_tpu/data/cc3m.py``, which implements what
the reference's broken loader meant: a list of tab-separated image path
and caption lines under ``root``; an unreadable image is replaced by the
next index's sample.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .base import Dataset
from .textimage import caption_tokenizer
from .transforms import EvalTransform, TrainTransform, load_image


class CC3MBase(Dataset):
    split = "train"
    train = True

    def __init__(self, root: str, resolution: int = 256,
                 tokenizer: Optional[dict] = None, text_len: int = 77,
                 truncate_captions: bool = True) -> None:
        self.root = Path(root)
        self.tokenizer = caption_tokenizer(tokenizer)
        self.text_len = text_len
        self.truncate_captions = truncate_captions

        self.items = []
        with open(self.root / f"{self.split}_list.txt") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                img_path, text = line.split("\t", 1)
                self.items.append((img_path, text))
        self.transform = (TrainTransform(resolution) if self.train
                          else EvalTransform(resolution))

    def __len__(self) -> int:
        return len(self.items)

    def _skip_sample(self, idx: int):
        return self[(idx + 1) % len(self)]

    def __getitem__(self, idx: int):
        img_path, text = self.items[idx]
        try:
            img = self.transform(load_image(str(self.root / img_path)))
        except (OSError, ValueError):
            return self._skip_sample(idx)
        tokens = self.tokenizer.tokenize(text, self.text_len,
                                         truncate_text=self.truncate_captions)
        return {"image": img, "caption": np.asarray(tokens, np.int32)}


class CC3MTrain(CC3MBase):
    split, train = "train", True


class CC3MValidation(CC3MBase):
    split, train = "val", False
