"""Condition models that wrap a stage-1 tokenizer.

The port's counterpart of ``enhancing_tpu/models/cond/vqcond.py``:
:func:`VQCond` builds any stage-1 class as a condition encoder and adds
``to_img``; :func:`VQSegmentation` wraps one for label maps (``channels =
n_labels`` in its towers), with a fixed random colorize projection and
logit -> one-hot reconstructions in ``log_images``; it trains through the
Trainer's stage-1 branch on ``losses.BCELossWithQuant``. ``base_class``
may name the JAX package (as configs do): it is resolved in the port.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...utils.config import JAX_PREFIX, PORT_PREFIX, get_obj_from_str


def _port_class(base_class: str):
    if base_class.startswith(JAX_PREFIX):
        base_class = PORT_PREFIX + base_class[len(JAX_PREFIX):]
    return get_obj_from_str(base_class)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def VQCond(base_class: str, *args, **kwargs):
    """Build ``base_class`` (a stage-1 tokenizer) as a condition encoder
    whose ``to_img`` clips to [0, 1]."""
    model = _port_class(base_class)(*args, **kwargs)
    model.to_img = lambda x: torch.clamp(_tensor(x), 0.0, 1.0)
    return model


def VQSegmentation(base_class: str, n_labels: int, *args, **kwargs):
    """Build ``base_class`` for segmentation-map conditioning: ``to_img``
    projects (..., n_labels) maps to RGB through a fixed random (n_labels,
    3) matrix (numpy's ``default_rng(0)``, as the JAX package draws it) and
    scales the result to [0, 1]; ``log_images`` shows the inputs and the
    one-hot argmax of the reconstruction's logits that way."""
    base_cls = _port_class(base_class)

    class Wrapper(base_cls):  # type: ignore[misc, valid-type]
        def __init__(self) -> None:
            super().__init__(*args, **kwargs)
            rng = np.random.default_rng(0)
            self.colorize = torch.from_numpy(rng.standard_normal(
                (n_labels, 3)).astype(np.float32))
            self.n_labels = n_labels

        def to_img(self, x) -> torch.Tensor:
            x = _tensor(x).float()
            out = x @ self.colorize.to(x.device)
            lo, hi = out.min(), out.max()
            return (out - lo) / torch.clamp_min(hi - lo, 1e-8)

        def log_images(self, batch: Dict[str, Any],
                       **kwargs) -> Dict[str, torch.Tensor]:
            x = self.get_input(batch, self.image_key)
            xrec, _ = self(x)
            xrec = xrec.float()
            if x.shape[-1] > 3:
                xrec = torch.nn.functional.one_hot(
                    torch.argmax(xrec, dim=-1), x.shape[-1]).float()
                x, xrec = self.to_img(x), self.to_img(xrec)
            return {"inputs": x, "reconstructions": xrec}

    return Wrapper()
