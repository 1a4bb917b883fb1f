"""What the user scripts share: the config and model they build."""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple


def load_model(config: str, ckpt: Optional[str], device: str
               ) -> Tuple[object, object]:
    """(config, model) of ``configs/<config>.yaml`` on ``device``, its
    ``path`` set to ``ckpt`` where given."""
    from ..utils.config import get_config_from_file, initialize_from_config
    cfg = get_config_from_file(Path("configs") / f"{config}.yaml")
    model_cfg = cfg.model.to_dict()
    if ckpt:
        model_cfg.setdefault("params", {})["path"] = ckpt
    return cfg, initialize_from_config(model_cfg, device=device)


def loader(cfg, split: str, batch_size: Optional[int] = None):
    """The config's dataset loader of ``split`` (validation or train)."""
    from ..utils.config import initialize_from_config
    data_cfg = cfg.dataset.to_dict()
    if batch_size:
        data_cfg["params"]["batch_size"] = batch_size
    data = initialize_from_config(data_cfg)
    data.setup()
    return (data.val_dataloader() if split == "validation"
            else data.train_dataloader())
