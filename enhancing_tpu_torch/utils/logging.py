"""Image-grid and scalar logging: local PNGs, ``metrics.jsonl``, optional
wandb.

Counterpart of ``enhancing_tpu/utils/logging.py``: :func:`make_grid` tiles
a batch into one uint8 image, :func:`save_image_grid` writes it as a PNG,
:class:`JsonlLogger` appends one JSON object per logged step to the run
directory's ``metrics.jsonl``, :class:`MultiLogger` fans calls out and
:class:`WandbLogger` pushes to wandb when the package imports.

The PNG is written with ``zlib`` and ``struct`` (filter 0 on every row),
so logging needs no Pillow.
"""
from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

try:
    import wandb  # type: ignore
    HAS_WANDB = True
except ImportError:
    wandb = None
    HAS_WANDB = False


def _numpy(images) -> np.ndarray:
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    return np.asarray(images, np.float32)


def make_grid(images, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) float [0, 1] -> one HWC uint8 grid image."""
    images = np.clip(_numpy(images), 0.0, 1.0)
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrows = -(-b // ncol)
    grid = np.ones((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   np.float32)
    for i in range(b):
        r, cl = divmod(i, ncol)
        top = r * (h + pad) + pad
        left = cl * (w + pad) + pad
        grid[top:top + h, left:left + w] = images[i]
    return (grid * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An HW, HW1 or HW3 uint8 array as PNG bytes (8-bit grey or RGB)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"a PNG needs HW, HW1 or HW3 pixels, got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image_grid(images, path: str | Path, nrow: int = 4) -> None:
    grid = make_grid(images, nrow)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(grid))


class JsonlLogger:
    """Append-only ``metrics.jsonl`` in the run dir: one
    ``{"step": N, ...metrics}`` object per logged step."""

    def __init__(self, save_dir: str) -> None:
        self.path = Path(save_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step),
                                **{k: float(v) for k, v in metrics.items()}},
                               sort_keys=True) + "\n")

    def log_images(self, tag: str, images, step: int) -> None:
        pass  # grids go through the ImageLogger callback's local PNGs


class MultiLogger:
    """Fan out log calls to several metric loggers."""

    def __init__(self, *loggers) -> None:
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_images(self, tag: str, images, step: int) -> None:
        for lg in self.loggers:
            lg.log_images(tag, images, step)


class WandbLogger:
    """Thin wandb wrapper, on only where the package imports."""

    def __init__(self, save_dir: str, name: str, enabled: bool = True) -> None:
        self.enabled = enabled and HAS_WANDB
        if self.enabled:
            self.run = wandb.init(dir=save_dir, name=name, reinit=True)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self.enabled:
            wandb.log(dict(metrics), step=step)

    def log_images(self, tag: str, images, step: int) -> None:
        if self.enabled:
            wandb.log({tag: [wandb.Image(make_grid(images))]}, step=step)
