"""Training callbacks: experiment setup and periodic image logging.

Counterpart of ``enhancing_tpu/utils/callback.py``: :class:`SetupCallback`
creates the run directory's ``log/`` and ``ckpt/`` and writes
``config.yaml`` (through the port's own YAML writer, :mod:`.yaml_io`);
:class:`ImageLogger` renders the model's ``log_images`` grids every
``batch_frequency`` steps and on the early log2 ladder (``2**6``,
``2**7``, ... below ``batch_frequency``, each once), as local PNGs and to
wandb when a logger holds it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from . import yaml_io
from .logging import WandbLogger, save_image_grid


def is_main_process() -> bool:
    """Rank 0 of an initialised ``torch.distributed``; True without one."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class SetupCallback:
    """Rank-0 creation of the log and checkpoint directories and the
    config dump."""

    def __init__(self, config: dict, exp_config: dict,
                 basedir: str | Path) -> None:
        self.config = config
        self.exp_config = exp_config
        self.basedir = Path(basedir)
        self.logdir = self.basedir / "log"
        self.ckptdir = self.basedir / "ckpt"

    def on_fit_start(self) -> None:
        if not is_main_process():
            return
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.ckptdir.mkdir(parents=True, exist_ok=True)
        yaml_io.dump({"config": _plain(self.config),
                      "exp_config": _plain(self.exp_config)},
                     self.basedir / "config.yaml")


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


class ImageLogger:
    """Periodic image grids: every ``batch_frequency`` steps and the 2**n
    ladder."""

    def __init__(self, batch_frequency: int = 750, max_images: int = 4,
                 logdir: Optional[str | Path] = None,
                 wandb_logger: Optional[WandbLogger] = None) -> None:
        self.batch_frequency = batch_frequency
        self.max_images = max_images
        self.logdir = Path(logdir) if logdir else None
        self.wandb_logger = wandb_logger
        self.log_steps = [2 ** n for n in range(6, int(np.log2(
            max(batch_frequency, 2))) + 1) if 2 ** n < batch_frequency]

    def check_frequency(self, step: int) -> bool:
        if step % self.batch_frequency == 0:
            return True
        if step in self.log_steps:
            self.log_steps.remove(step)
            return True
        return False

    def log_img(self, model, batch: Dict, step: int,
                split: str = "train", check_idx: Optional[int] = None,
                **kwargs) -> None:
        """Log ``model.log_images`` of the batch's first ``max_images``
        samples when the frequency, checked on ``check_idx`` (the
        validation batch's index) or else ``step``, says so; files are
        named by ``step``."""
        check_idx = step if check_idx is None else check_idx
        if not (is_main_process() and self.check_frequency(check_idx)
                and hasattr(model, "log_images")):
            return
        batch = {k: (v[: self.max_images] if hasattr(v, "__getitem__")
                     else v) for k, v in batch.items()}
        images = model.log_images(batch, **kwargs)
        for tag, imgs in images.items():
            if hasattr(imgs, "detach"):
                imgs = imgs.detach().float().cpu().numpy()
            imgs = np.clip(np.asarray(imgs), 0.0, 1.0)
            if self.logdir is not None:
                fname = (self.logdir / "results" / split /
                         f"{tag.replace(' ', '_')}_step{step:08d}.png")
                save_image_grid(imgs, fname, nrow=self.max_images)
            if self.wandb_logger is not None:
                self.wandb_logger.log_images(f"{split}/{tag}", imgs, step)
