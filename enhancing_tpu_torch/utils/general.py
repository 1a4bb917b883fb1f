"""General utilities: seeding and the standard experiment callbacks.

Counterpart of ``enhancing_tpu/utils/general.py``: config loading and
instantiation live in :mod:`.config` (re-exported here); this adds
:func:`set_seed` and :func:`setup_callbacks`.
"""
from __future__ import annotations

import random
from datetime import datetime
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .callback import ImageLogger, SetupCallback
from .config import (  # noqa: F401  (re-exported, as in the JAX package)
    get_config_from_file,
    get_obj_from_str,
    initialize_from_config,
)
from .logging import WandbLogger


def set_seed(seed: int) -> None:
    """Seed the host-side ``random`` and numpy generators; the port's own
    draws take explicit ``torch.Generator`` objects."""
    random.seed(seed)
    np.random.seed(seed)


def setup_callbacks(exp_config: dict, config: dict,
                    base_path: str = "experiments"
                    ) -> Tuple[List, WandbLogger, Path]:
    """A timestamped run directory and the standard callbacks. Returns
    (callbacks, logger, basedir)."""
    now = datetime.now().strftime("%d%m%Y_%H%M%S")
    basedir = Path(base_path) / exp_config["name"] / now
    basedir.mkdir(parents=True, exist_ok=True)

    setup_cb = SetupCallback(config, exp_config, basedir)
    logger = WandbLogger(str(basedir), f"{exp_config['name']}_{now}")
    image_cb = ImageLogger(exp_config.get("batch_frequency", 750),
                           exp_config.get("max_images", 4),
                           logdir=basedir / "log", wandb_logger=logger)
    return [setup_cb, image_cb], logger, basedir
