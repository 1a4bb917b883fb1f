"""Paired text/image files matched by stem, with corrupt-sample skipping.

The port's copy of ``enhancing_tpu/data/textimage.py``: each sample is an
image file and a same-stem ``.txt`` caption file (one caption a line),
BPE-tokenized; an unreadable sample or one without a caption is replaced
by the next index's.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Optional

import numpy as np

from .base import Dataset
from .transforms import IMG_EXTENSIONS, EvalTransform, TrainTransform, \
    load_image


def caption_tokenizer(tokenizer: Optional[dict]):
    """The CLIP tokenizer, or the one ``tokenizer`` configures."""
    from ..utils.config import initialize_from_config
    from ..utils.tokenizer import SimpleTokenizer
    return initialize_from_config(tokenizer) if tokenizer \
        else SimpleTokenizer()


class TextImageBase(Dataset):
    train = True

    def __init__(self, root: str, resolution: int = 256,
                 tokenizer: Optional[dict] = None,
                 text_len: int = 77, truncate_captions: bool = True,
                 shuffle_captions: bool = False) -> None:
        self.root = Path(root)
        self.tokenizer = caption_tokenizer(tokenizer)
        self.text_len = text_len
        self.truncate_captions = truncate_captions
        self.shuffle_captions = shuffle_captions

        text_files = {p.stem: p for p in self.root.glob("**/*.txt")}
        image_files = {p.stem: p for p in self.root.glob("**/*")
                       if p.suffix.lower() in IMG_EXTENSIONS}
        self.keys = sorted(set(text_files) & set(image_files))
        self.text_files = text_files
        self.image_files = image_files
        self.transform = (TrainTransform(resolution) if self.train
                          else EvalTransform(resolution))

    def __len__(self) -> int:
        return len(self.keys)

    def _skip_sample(self, idx: int):
        return self[(idx + 1) % len(self)]

    def __getitem__(self, idx: int):
        key = self.keys[idx]
        try:
            descriptions = [d for d in
                            self.text_files[key].read_text().split("\n")
                            if d.strip()]
            if not descriptions:
                return self._skip_sample(idx)
            if self.shuffle_captions:
                description = random.choice(descriptions)
            else:
                description = descriptions[0]
            tokens = self.tokenizer.tokenize(
                description, self.text_len,
                truncate_text=self.truncate_captions)
            img = self.transform(load_image(str(self.image_files[key])))
        except (OSError, ValueError):
            return self._skip_sample(idx)
        return {"image": img, "caption": np.asarray(tokens, np.int32)}


class TextImageTrain(TextImageBase):
    train = True


class TextImageValidation(TextImageBase):
    train = False
