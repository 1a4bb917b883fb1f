"""Condition encoders: identity conditions and class-index conditions with
render-to-image logging.

The port's copy of ``enhancing_tpu/models/cond/dummycond.py``: host-side
objects with no parameters; ``encode_codes`` is the identity on class ids
and on BPE caption tokens, ``to_img`` renders each class name or decoded
caption as an image for logging (Pillow, imported when rendering).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from ...utils.config import initialize_from_config


class DummyCond:
    """Identity condition model."""

    def encode(self, condition: Any) -> Tuple[Any, Any, Any]:
        return condition, None, condition

    def decode(self, condition: Any) -> Any:
        return condition

    def encode_codes(self, condition: Any) -> Any:
        return condition

    def decode_codes(self, condition: Any) -> Any:
        return condition


def _find_font(size: int = 12):
    """The repository's DejaVuSans (``assets/font/``), or a user-supplied
    ``assets/font/arial.ttf``, so render grids are the same on every host."""
    from PIL import ImageFont
    repo_assets = Path(__file__).resolve().parents[3] / "assets" / "font"
    for cand in (Path(os.getcwd()) / "assets" / "font" / "arial.ttf",
                 repo_assets / "arial.ttf",
                 repo_assets / "DejaVuSans.ttf",
                 Path("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")):
        if cand.is_file():
            try:
                return ImageFont.truetype(str(cand), size)
            except OSError:
                continue
    return ImageFont.load_default()


def _render_text(text: str, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image, ImageDraw
    W, H = size
    img = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(img)
    font = _find_font(12)
    # word-wrap roughly every 27 characters
    words, lines, cur = text.split(), [], ""
    for word in words:
        if len(cur) + len(word) > 27:
            lines.append(cur)
            cur = word
        else:
            cur = (cur + " " + word).strip()
    lines.append(cur)
    wrapped = "\n".join(lines)
    bbox = draw.multiline_textbbox((0, 0), wrapped, font=font)
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    draw.multiline_text(((W - w) / 2, (H - h) / 2), wrapped, font=font,
                        fill="black", align="center")
    return np.asarray(img).astype(np.float32) / 255.0


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


class TextCond(DummyCond):
    """Raw BPE-token text condition: the CLIP tokenizer of
    ``utils.tokenizer``, or the one ``tokenizer`` configures."""

    def __init__(self, image_size: Union[int, Tuple[int, int]],
                 tokenizer: Optional[dict] = None) -> None:
        from ...utils.tokenizer import SimpleTokenizer
        self.image_size = image_size
        self.tokenizer = (initialize_from_config(tokenizer) if tokenizer
                          else SimpleTokenizer())

    def to_img(self, texts) -> np.ndarray:
        """(B, H, W, 3) fp32 images in [0, 1], each a decoded caption."""
        size = (self.image_size, self.image_size) \
            if isinstance(self.image_size, int) else tuple(self.image_size)
        return np.stack([_render_text(self.tokenizer.decode(t), size)
                         for t in _host(texts)])


class ClassCond(DummyCond):
    """Class-index condition with names from a txt file or a list."""

    def __init__(self, image_size: Union[int, Tuple[int, int]],
                 class_name: Union[str, List[str]]) -> None:
        self.img_size = image_size
        if isinstance(class_name, str):
            if class_name.endswith("txt") and os.path.isfile(class_name):
                with open(class_name) as f:
                    self.cls_name = f.read().split("\n")
            elif "." not in class_name and not os.path.isfile(class_name):
                self.cls_name = [class_name]
            else:
                raise ValueError(
                    f"Class file {class_name!r} not found or unsupported")
        elif isinstance(class_name, (list, tuple)) and \
                isinstance(class_name[0], str):
            self.cls_name = list(class_name)
        else:
            raise ValueError("Class file format not supported")

    @property
    def num_classes(self) -> int:
        return len(self.cls_name)

    def to_img(self, clss) -> np.ndarray:
        """(B, H, W, 3) fp32 images in [0, 1], each a class name."""
        size = (self.img_size, self.img_size) \
            if isinstance(self.img_size, int) else tuple(self.img_size)
        imgs = [_render_text(self.cls_name[int(c)], size)
                for c in _host(clss).reshape(-1)]
        return np.stack(imgs)
