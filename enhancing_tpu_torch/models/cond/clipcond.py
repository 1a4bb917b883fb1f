"""Frozen CLIP features as condition codes, gated on weights.

Counterpart of ``enhancing_tpu/models/cond/clipcond.py``: the text or
image tower of :mod:`.clip` encodes a batch into (B, embed_dim) features
under ``torch.no_grad``. The only gate is the pretrained weights: without
network access nothing can download them, so the constructor needs
``clip_params_path`` (a torch CLIP checkpoint, e.g. the state dict of
``clip.load("ViT-B/32")``) and raises the JAX package's error otherwise.
The towers run on ``device`` (default ``cuda``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .clip import CLIP_CONFIGS, load_torch_clip, preprocess_images
from .dummycond import DummyCond, TextCond


def _load(clip_model: str, clip_params_path: Optional[str], which: str,
          device):
    if clip_params_path is None:
        raise RuntimeError(
            f"CLIP condition model '{clip_model}' needs pretrained weights; "
            "this environment has no network egress. Provide "
            "clip_params_path= pointing at a torch CLIP checkpoint "
            "(the state_dict of clip.load(...)).")
    cfg = CLIP_CONFIGS.get(clip_model)
    return load_torch_clip(clip_params_path, which=which, cfg=cfg,
                           device=device)


def _tensor(x, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """``x`` (an array or a tensor) as ``dtype`` on ``like``'s device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=like.device, dtype=dtype)


class ClipTextCond(TextCond):
    """Frozen CLIP text features of (B, T) BPE tokens; ``to_img`` renders
    the decoded captions as :class:`TextCond` does."""

    def __init__(self, image_size: Union[int, Tuple[int, int]],
                 clip_model: str, tokenizer: Optional[dict] = None,
                 clip_params_path: Optional[str] = None,
                 device: str | torch.device | None = None) -> None:
        super().__init__(image_size, tokenizer)
        self.config, towers = _load(clip_model, clip_params_path, "text",
                                    device)
        self.module = towers["text"]

    @torch.no_grad()
    def encode_codes(self, text) -> torch.Tensor:
        """(B, T) BPE tokens, zero-padded to the context length ->
        (B, embed_dim) features."""
        tokens = _tensor(text, torch.long, self.module.text_projection)
        pad = self.config.context_length - tokens.shape[1]
        if pad > 0:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
        return self.module(tokens)


class ClipImageCond(DummyCond):
    """Frozen CLIP image features of (B, H, W, 3) images in [0, 1]."""

    def __init__(self, clip_model: str,
                 clip_params_path: Optional[str] = None,
                 device: str | torch.device | None = None) -> None:
        self.config, towers = _load(clip_model, clip_params_path, "visual",
                                    device)
        self.module = towers["visual"]

    @torch.no_grad()
    def encode_codes(self, image) -> torch.Tensor:
        """Images resized (bicubic, antialiased) to the tower's resolution
        and CLIP-normalized -> (B, embed_dim) features."""
        x = _tensor(image, torch.float32, self.module.proj)
        return self.module(preprocess_images(
            x, self.config.image_resolution))

    def to_img(self, image) -> np.ndarray:
        return np.clip(np.asarray(image), 0.0, 1.0)
