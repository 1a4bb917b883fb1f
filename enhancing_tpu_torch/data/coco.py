"""MS-COCO captions, with optional stuff+thing segmentation maps.

The port's copy of ``enhancing_tpu/data/coco.py``: captions from the
annotations json (a random one of an image's captions when training, the
first otherwise), BPE-tokenized, and optionally the one-hot segmentation
map cut by the same resize and crop as the image.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Optional

import numpy as np

from .base import Dataset
from .textimage import caption_tokenizer
from .transforms import load_image, resize, to_float


class CocoBase(Dataset):
    split = "train"
    train = True
    year = 2017

    def __init__(self, root: str, resolution: int = 256,
                 tokenizer: Optional[dict] = None, text_len: int = 77,
                 use_segmentation: bool = False, n_labels: int = 183,
                 crop_size: Optional[int] = None) -> None:
        self.root = Path(root)
        self.resolution = resolution
        self.crop_size = crop_size or resolution
        self.use_segmentation = use_segmentation
        self.n_labels = n_labels
        self.text_len = text_len
        self.tokenizer = caption_tokenizer(tokenizer)

        split_name = f"{self.split}{self.year}"
        self.img_dir = self.root / split_name
        ann_file = self.root / "annotations" / f"captions_{split_name}.json"
        with open(ann_file) as f:
            ann = json.load(f)
        self.img_info = {im["id"]: im["file_name"] for im in ann["images"]}
        self.captions: dict = {}
        for a in ann["annotations"]:
            self.captions.setdefault(a["image_id"], []).append(a["caption"])
        self.ids = sorted(self.captions)
        self.seg_dir = self.root / "annotations" / f"stuffthingmaps_{split_name}"

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int):
        img_id = self.ids[idx]
        img = load_image(str(self.img_dir / self.img_info[img_id]))

        seg = None
        if self.use_segmentation:
            from PIL import Image
            seg_path = self.seg_dir / (
                Path(self.img_info[img_id]).stem + ".png")
            with Image.open(seg_path) as seg_img:
                seg = np.asarray(seg_img)

        # one resize and crop for image and segmentation, so they align
        img = resize(img, self.resolution)
        if seg is not None:
            seg = np.asarray(Image.fromarray(seg).resize(
                (img.shape[1], img.shape[0]), Image.NEAREST))
        h, w = img.shape[:2]
        size = self.crop_size
        if self.train:
            top = random.randint(0, max(0, h - size))
            left = random.randint(0, max(0, w - size))
        else:
            top, left = max(0, (h - size) // 2), max(0, (w - size) // 2)
        img = img[top:top + size, left:left + size]
        if seg is not None:
            seg = seg[top:top + size, left:left + size]

        caps = self.captions[img_id]
        caption = random.choice(caps) if self.train else caps[0]
        tokens = self.tokenizer.tokenize(caption, self.text_len,
                                         truncate_text=True)
        out = {"image": to_float(np.ascontiguousarray(img)),
               "caption": np.asarray(tokens, np.int32)}
        if seg is not None:
            out["segmentation"] = np.eye(self.n_labels, dtype=np.float32)[
                np.clip(seg, 0, self.n_labels - 1)]
        return out


class CocoTrain(CocoBase):
    split, train = "train", True


class CocoValidation(CocoBase):
    split, train = "val", False
