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


def _from_torch_layout(array: np.ndarray) -> np.ndarray:
    if array.ndim == 4:
        return array.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return array.T


def to_jax_tree(module: nn.Module) -> dict:
    """The parameters of ``module`` as a JAX-named tree of fp32 numpy
    arrays in the JAX layouts, the inverse of the names and layouts here:
    ``compat.torch_loader`` edits such a tree as the JAX package edits its
    own, and the loaders here fill the module back from it. A ``weight``'s
    JAX leaf follows its owner: an nn.Embedding's is an ``embedding`` (in
    the GPT prior and the CLIP text tower), a LayerNorm's 1-D weight a
    ``scale``, an nn.Linear's (``Dense``) or nn.Conv2d's a ``kernel``, and
    any other 2-D or 4-D weight (``EqualLinear``, ``EqualConv2d``) stays a
    ``weight``; kernels and weights change layout back."""
    modules = dict(module.named_modules())
    tree: dict = {}
    for name, param in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        array = param.detach().float().cpu().numpy()
        if leaf == "weight":
            kind = modules[owner]
            if isinstance(kind, nn.Embedding):
                leaf = "embedding"
            elif array.ndim == 1:
                leaf = "scale"
            else:
                array = _from_torch_layout(array)
                if isinstance(kind, (nn.Linear, nn.Conv2d)):
                    leaf = "kernel"
        node = tree
        for part in owner.split(".") if owner else ():
            node = node.setdefault(part, {})
        node[leaf] = array
    return tree


def load_vitvq_from_jax(model: Any, params: Mapping) -> Any:
    """Fill ``model`` (a ``ViTVQ`` or its ``ViTVQModule``) from ``params``,
    the JAX ``ViTVQ.params`` tree with numpy leaves, each stack unrolled
    (``layers_{i}``) or stacked (``layers``, ``scan_layers=True``).
    Returns ``model``."""
    load_from_jax(getattr(model, "module", model),
                  _unstack_layers(params, "layers"))
    return model


def load_style_discriminator_from_jax(disc: nn.Module,
                                      params: Mapping) -> nn.Module:
    """Fill a port ``StyleDiscriminator`` from the JAX loss's
    ``disc_init_params`` (numpy leaves)."""
    return load_from_jax(disc, params)


def load_patch_discriminator_from_jax(disc: nn.Module,
                                      variables: Mapping) -> nn.Module:
    """Fill a port ``PatchDiscriminator`` from the JAX module's variables
    (numpy leaves): ``params`` as :func:`load_from_jax` does, and the
    ``batch_stats`` collection (BatchNorm's ``mean`` / ``var``, ActNorm's
    ``loc`` / ``scale`` / ``initialized``) into the buffers of the same
    names. A leaf without a buffer, a buffer left unfilled or a shape
    mismatch raises."""
    load_from_jax(disc, variables["params"])
    targets = dict(disc.named_buffers())
    filled = set()
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        name = ".".join(path)
        if name not in targets:
            raise KeyError(f"JAX batch_stats leaf {'/'.join(path)} has no "
                           f"buffer {name!r} in the port")
        buf = targets[name]
        array = np.asarray(leaf)
        if tuple(array.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: JAX shape {array.shape} != port "
                             f"shape {tuple(buf.shape)}")
        buf.copy_(torch.tensor(np.array(array)))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port buffers with no JAX batch_stats leaf: "
                       f"{missing}")
    return disc


def load_lpips_from_jax(lpips: nn.Module, params: Mapping) -> nn.Module:
    """Fill a port ``LPIPS`` from the JAX loss's ``lpips_params``."""
    return load_from_jax(lpips, params)


def _gpt_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    # an nn.Embed table (num, dim) is torch's Embedding weight as it is
    if path[-1] == "embedding":
        return ".".join([*path[:-1], "weight"]), False
    return torch_name(path)


def load_clip_from_jax(tower: nn.Module, params: Mapping) -> nn.Module:
    """Fill a port CLIP tower (``models.cond.clip``'s
    ``CLIPVisionTransformer`` or ``CLIPTextTransformer``) from the JAX
    tower's ``params`` (numpy leaves): Dense kernels transposed, the
    vision ``conv1`` kernel from (kh, kw, in, out) to (out, in, kh, kw),
    the ``token_embedding`` table, the class and position embeddings and
    the projections as they are. A missing or left-over leaf and a shape
    mismatch raise. Returns ``tower``."""
    return load_from_jax(tower, params, name_fn=_gpt_name)


def _unstack_layers(tree: Mapping, key: str = "blocks") -> dict:
    """A ``scan_layers=True`` tree with each stacked ``key`` subtree, whose
    leaves carry a leading layer axis, split into ``{key}_{i}``: the GPT's
    top-level ``blocks``, the RQ prior's ``spatial`` and ``depth``, or each
    ViT stack's ``transformer/layers``."""

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    out = {}
    for name, node in tree.items():
        if name == key and isinstance(node, Mapping):
            _, leaf = next(_leaves(node))
            for i in range(np.shape(leaf)[0]):
                out[f"{key}_{i}"] = take(node, i)
        elif isinstance(node, Mapping):
            out[name] = _unstack_layers(node, key)
        else:
            out[name] = node
    return out


def _load_quant(prior: Any, quant: Mapping) -> None:
    """Fill the int8 twins of a prior from JAX's ``quant`` collection, its
    stacks already unstacked: ``kernel_q`` (d, n) int8 becomes the port's
    (n, d) ``weight_q``, ``scale`` (n,) stays. A leaf without a twin, or a
    twin without a leaf, raises KeyError."""
    from ..models.stage2.quantize import attach_int8_buffers
    attach_int8_buffers(prior)
    modules = dict(prior.named_modules())
    filled = set()
    for path, leaf in _leaves(quant):
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
            target.copy_(torch.tensor(np.ascontiguousarray(array)))
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
    params, quant = _split_variables(params)
    load_from_jax(gpt, _unstack_layers(params), name_fn=_gpt_name)
    if quant is not None:
        _load_quant(gpt, _unstack_layers(quant))
    return model


def _split_variables(params: Mapping) -> Tuple[Mapping, Any]:
    """(the ``params`` tree, the ``quant`` collection or None) of a JAX
    ``params`` tree or of its variables ``{"params": ..., "quant": ...}``."""
    if "params" in params or "quant" in params:
        return params["params"], params.get("quant")
    return params, None


def load_rq_from_jax(model: Any, params: Mapping) -> Any:
    """Fill a port ``RQTransformer`` (or the prior of a ``CondTransformer``)
    from the JAX RQTransformer's parameters, numpy leaves, of either
    layout: the scanned ``spatial`` and ``depth`` stacks
    (``scan_layers=True``, the JAX default) or ``spatial_{i}`` and
    ``depth_{i}``. Names and layouts as in :func:`load_gpt_from_jax`, and
    as there ``params`` may be the variables ``{"params": ..., "quant":
    ...}`` of the JAX ``quantize_decode_params``, whose ``quant`` (in
    either layout) fills the int8 twins of every GEMM. A missing or
    left-over leaf, in either collection, and a shape mismatch raise.
    Returns ``model``."""
    rq = getattr(model, "transformer", model)
    params, quant = _split_variables(params)

    def unstack(tree):
        return _unstack_layers(_unstack_layers(tree, "spatial"), "depth")

    load_from_jax(rq, unstack(params), name_fn=_gpt_name)
    if quant is not None:
        _load_quant(rq, unstack(quant))
    return model


# the JAX BasicConv2d's leaves -> the port's (torchvision's) names
_INCEPTION_LEAVES = {"kernel": "conv.weight", "scale": "bn.weight",
                     "bias": "bn.bias", "mean": "bn.running_mean",
                     "var": "bn.running_var"}


def load_inception_from_jax(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill a port ``eval.InceptionV3Pool3`` from the JAX module's params
    (numpy leaves): each BasicConv2d's HWIO ``kernel`` becomes the conv's
    OIHW weight, ``scale`` / ``bias`` the BatchNorm's affine parameters and
    ``mean`` / ``var`` its running statistics. A leaf without a
    counterpart, a tensor left unfilled or a shape mismatch raises."""
    targets = dict(module.named_parameters())
    targets.update((k, v) for k, v in module.named_buffers()
                   if not k.endswith("num_batches_tracked"))
    filled = set()
    for path, leaf in _leaves(params):
        *owner, name = path
        if name not in _INCEPTION_LEAVES:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart")
        key = ".".join([*owner, _INCEPTION_LEAVES[name]])
        if key not in targets:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart "
                           f"{key!r} in the port")
        array = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            array = _to_torch_layout(array)
        if tuple(array.shape) != tuple(targets[key].shape):
            raise ValueError(f"{key}: JAX shape {np.shape(leaf)} != port "
                             f"shape {tuple(targets[key].shape)}")
        with torch.no_grad():
            targets[key].copy_(torch.tensor(np.ascontiguousarray(array)))
        filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port tensors with no JAX leaf: {missing[:4]} "
                       f"({len(missing)} in all)")
    return module
