"""Carry a JAX ``ViTVQ.params`` tree (numpy leaves) into the port's module.

The port names its submodules after the JAX tree, so the mapping is
mechanical: a Dense ``kernel`` (in, out) becomes ``Linear.weight``
(out, in); a LayerNorm ``scale`` becomes ``weight``; ``bias`` and the
quantizer's ``embedding`` keep their names. Parameters stored in bf16 are
rounded on the copy, as the JAX modules round them when they cast. Any
leaf without a counterpart, any parameter left unfilled and any shape
mismatch raises.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    else:
        yield path, tree


def torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(parameter name in the port, whether the array is transposed)."""
    *modules, leaf = path
    if leaf == "kernel":
        return ".".join([*modules, "weight"]), True
    if leaf == "scale":
        return ".".join([*modules, "weight"]), False
    return ".".join(path), False


def load_vitvq_from_jax(model: Any, params: Mapping) -> Any:
    """Fill ``model`` (a ``ViTVQ`` or its ``ViTVQModule``) from ``params``,
    the JAX ``ViTVQ.params`` tree with numpy leaves. Returns ``model``."""
    module: nn.Module = getattr(model, "module", model)
    targets = dict(module.named_parameters())
    filled = set()
    for path, leaf in _leaves(params):
        name, transpose = torch_name(path)
        if name not in targets:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart "
                           f"{name!r} in the port")
        array = np.asarray(leaf, dtype=np.float32)
        if transpose:
            array = array.T
        param = targets[name]
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(f"{name}: JAX shape {array.shape} (after "
                             f"transpose: {transpose}) != port shape "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(array))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return model
