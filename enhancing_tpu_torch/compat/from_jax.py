"""Carry JAX parameter trees (numpy leaves) into the port's modules.

The port names its submodules after the JAX trees, so the mapping is
mechanical. A leaf ``kernel`` becomes ``weight``, and so does a LayerNorm
``scale``; ``kernel`` and ``weight`` leaves change layout: a 2-D Dense or
EqualLinear (in, out) array becomes torch's (out, in), a 4-D HWIO conv
kernel becomes OIHW for ``F.conv2d``. Other leaves (``bias``,
``act_bias``, the quantizer's ``embedding``) keep name and layout; in the
GPT prior an ``nn.Embed`` table's ``embedding`` becomes the port's
``weight``. The JAX leaves are fp32; each is cast to the dtype the port
stores it in. Any leaf without a counterpart, any parameter left unfilled
and any shape mismatch raises.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, Tuple

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
    """(parameter name in the port, whether the array changes layout)."""
    *modules, leaf = path
    if leaf in ("kernel", "scale", "weight"):
        return ".".join([*modules, "weight"]), leaf != "scale"
    return ".".join(path), False


def _to_torch_layout(array: np.ndarray) -> np.ndarray:
    if array.ndim == 4:
        return array.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return array.T


def load_from_jax(module: nn.Module, params: Mapping,
                  name_fn: Callable[[Tuple[str, ...]], Tuple[str, bool]]
                  = torch_name) -> nn.Module:
    """Fill every parameter of ``module`` from the JAX tree ``params``;
    ``name_fn`` maps a leaf's path to (port name, changes layout)."""
    targets = dict(module.named_parameters())
    filled = set()
    for path, leaf in _leaves(params):
        name, relayout = name_fn(path)
        if name not in targets:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart "
                           f"{name!r} in the port")
        array = np.asarray(leaf, dtype=np.float32)
        if relayout:
            array = _to_torch_layout(array)
        param = targets[name]
        if tuple(array.shape) != tuple(param.shape):
            raise ValueError(f"{name}: JAX shape {np.shape(leaf)} (in the "
                             f"port's layout {array.shape}) != port shape "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(np.ascontiguousarray(array)))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return module


def load_vitvq_from_jax(model: Any, params: Mapping) -> Any:
    """Fill ``model`` (a ``ViTVQ`` or its ``ViTVQModule``) from ``params``,
    the JAX ``ViTVQ.params`` tree with numpy leaves. Returns ``model``."""
    load_from_jax(getattr(model, "module", model), params)
    return model


def load_style_discriminator_from_jax(disc: nn.Module,
                                      params: Mapping) -> nn.Module:
    """Fill a port ``StyleDiscriminator`` from the JAX loss's
    ``disc_init_params`` (numpy leaves)."""
    return load_from_jax(disc, params)


def load_lpips_from_jax(lpips: nn.Module, params: Mapping) -> nn.Module:
    """Fill a port ``LPIPS`` from the JAX loss's ``lpips_params``."""
    return load_from_jax(lpips, params)


def _gpt_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    # an nn.Embed table (num, dim) is torch's Embedding weight as it is
    if path[-1] == "embedding":
        return ".".join([*path[:-1], "weight"]), False
    return torch_name(path)


def _unstack_layers(tree: Mapping) -> dict:
    """``blocks`` of a ``scan_layers=True`` tree, whose leaves carry a
    leading layer axis, split into ``blocks_{i}``."""
    tree = dict(tree)
    stacked = tree.pop("blocks", None)
    if stacked is None:
        return tree

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    _, leaf = next(_leaves(stacked))
    for i in range(np.shape(leaf)[0]):
        tree[f"blocks_{i}"] = take(stacked, i)
    return tree


def _load_gpt_quant(gpt: Any, quant: Mapping) -> None:
    """Fill the int8 twins from JAX's ``quant`` collection: ``kernel_q``
    (d, n) int8 becomes the port's (n, d) ``weight_q``, ``scale`` (n,)
    stays; a stacked ``blocks`` tree splits per layer."""
    from ..models.stage2.quantize import attach_int8_buffers
    attach_int8_buffers(gpt)
    modules = dict(gpt.named_modules())
    filled = set()
    for path, leaf in _leaves(_unstack_layers(quant)):
        *owner, name = path
        dense = modules.get(".".join(owner))
        if name not in ("kernel_q", "scale") or dense is None or \
                getattr(dense, "weight_q", None) is None:
            raise KeyError(f"JAX quant leaf {'/'.join(path)} has no int8 "
                           "twin in the port")
        array = np.asarray(leaf)
        if name == "kernel_q":
            target, array = dense.weight_q, array.T
        else:
            target = dense.scale
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {np.shape(leaf)}"
                             f" does not fit {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.ascontiguousarray(array)))
        filled.add((".".join(owner), name))
    wanted = {(n, leaf) for n, m in modules.items()
              if getattr(m, "weight_q", None) is not None
              for leaf in ("kernel_q", "scale")}
    if wanted - filled:
        raise KeyError(f"int8 twins with no JAX quant leaf: "
                       f"{sorted(wanted - filled)}")


def load_gpt_from_jax(model: Any, params: Mapping) -> Any:
    """Fill a port ``GPT`` (or the prior of a ``CondTransformer``) from the
    JAX GPT's parameters, numpy leaves, of either layout: stacked
    ``blocks`` (``scan_layers=True``, the JAX default) or ``blocks_{i}``.
    Dense kernels are transposed; ``embedding`` tables, ``time_mix`` and
    the position embeddings keep their layout. ``params`` is the ``params``
    tree, or the variables ``{"params": ..., "quant": ...}`` that the JAX
    ``quantize_decode_params`` returns, whose int8 ``kernel_q`` and
    ``scale`` fill the GEMMs' int8 twins (``kernel_q`` transposed to (out,
    in)). Returns ``model``."""
    gpt = getattr(model, "transformer", model)
    if "params" in params or "quant" in params:
        quant = params.get("quant")
        params = params["params"]
    else:
        quant = None
    load_from_jax(gpt, _unstack_layers(params), name_fn=_gpt_name)
    if quant is not None:
        _load_gpt_quant(gpt, quant)
    return model
