"""YAML config system with ``target``/``params`` reflective instantiation.

The port's own copy of ``enhancing_tpu/utils/config.py``: configs are YAML
trees where any node ``{target: "dotted.path.Class", params: {...}}`` is
buildable with :func:`initialize_from_config`, and a top-level
``base_config`` key merges a parent YAML recursively.

The repo's ``configs/*.yaml`` name the JAX package; :func:`load_config`
rewrites every ``target`` that starts with ``enhancing_tpu.`` to
``enhancing_tpu_torch.``, so the same files build port objects. Targets
the port does not have yet (losses, data, schedulers) are only rewritten;
the stage-1 models keep their ``loss:`` and ``temperature_scheduler:``
blocks as dicts and do not build them.

The files are read by the port's own standard-library reader
(:mod:`.yaml_io`), which resolves every scalar as ``yaml.safe_load``
does: nothing here needs pyyaml.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Mapping

from . import yaml_io

JAX_PREFIX = "enhancing_tpu."
PORT_PREFIX = "enhancing_tpu_torch."


class ConfigDict(dict):
    """A dict with attribute access and recursive wrapping, OmegaConf-style."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key: str) -> Any:
        # wrap in place, so mutations of a nested dict reach the config
        value = dict.__getitem__(self, key)
        wrapped = _wrap(value)
        if wrapped is not value and isinstance(value, (Mapping, list)):
            dict.__setitem__(self, key, wrapped)
        return wrapped

    def get(self, key: str, default: Any = None) -> Any:
        if key in self:
            return self[key]
        return _wrap(default)

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def remap_targets(value: Any) -> Any:
    """Rewrite every ``target`` naming the JAX package to the port."""
    if isinstance(value, Mapping):
        out = {k: remap_targets(v) for k, v in value.items()}
        target = out.get("target")
        if isinstance(target, str) and target.startswith(JAX_PREFIX):
            out["target"] = PORT_PREFIX + target[len(JAX_PREFIX):]
        return out
    if isinstance(value, list):
        return [remap_targets(v) for v in value]
    return value


def merge_configs(base: Mapping, override: Mapping) -> ConfigDict:
    """Deep merge: ``override`` wins; dicts merge recursively, lists replace."""
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], Mapping) and isinstance(value, Mapping):
            out[key] = merge_configs(out[key], value)
        else:
            out[key] = value
    return ConfigDict(out)


def load_config(path: str | Path) -> ConfigDict:
    """Load a YAML config, recursively merging an optional ``base_config``,
    with its targets remapped to the port."""
    path = Path(path)
    cfg = yaml_io.load(path) or {}
    cfg = remap_targets(cfg)
    if "base_config" in cfg:
        base_path = cfg.pop("base_config")
        if not str(base_path).endswith((".yaml", ".yml")):
            raise ValueError(f"base_config must be a YAML path, got {base_path!r}")
        base_path = Path(base_path)
        if not base_path.is_absolute():
            base_path = path.parent / base_path
        return merge_configs(load_config(base_path), cfg)
    return ConfigDict(cfg)


# the JAX package's (and the reference's) name for it
get_config_from_file = load_config


def get_obj_from_str(name: str) -> Any:
    """Resolve ``"pkg.module.Attr"`` to the attribute object."""
    module_name, attr = name.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), attr)


def initialize_from_config(config: Mapping, **extra_kwargs: Any) -> Any:
    """Build the object described by ``{target: ..., params: {...}}``;
    ``extra_kwargs`` (a ``device``, say) are merged over the params."""
    if "target" not in config:
        raise KeyError(f"Expected a 'target' key in config, got keys {list(config)}")
    params = _unwrap(config.get("params", {}) or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)
