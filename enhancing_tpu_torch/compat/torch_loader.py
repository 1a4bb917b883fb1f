"""Reference (PyTorch Lightning) checkpoints -> JAX-named numpy trees.

The port's copy of ``enhancing_tpu/compat/torch_loader.py``: the same
mapping of the reference's state_dict names onto the JAX package's
parameter trees, on trees of numpy arrays. A model of the port fills
itself from a checkpoint in two steps that keep one name map, the one of
``compat.from_jax``: ``from_jax.to_jax_tree(module)`` gives its current
parameters in the JAX names, a loader here overwrites what the checkpoint
holds (keys under ``ignore_keys`` and keys the tree lacks leave the
current values), and ``from_jax``'s loaders put the tree back. The
mappings:

- torch Linear weight (out, in)            -> Dense kernel (in, out)
- torch Conv2d patch-embed (out, c, p, p)  -> Dense kernel (c*p*p, out)
- torch ConvTranspose2d (in, c, p, p)      -> Dense kernel (in, c*p*p)
- torch LayerNorm weight/bias              -> scale/bias
- torch Embedding weight                   -> embedding

All are reshapes and transposes, exact in fp32. Each loader takes a
checkpoint path or a state dict that :func:`load_torch_state_dict` has
read, so a model reads its file once.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Sequence, Union

import numpy as np

StateDict = Dict[str, np.ndarray]


def load_torch_state_dict(path: str) -> StateDict:
    """The state dict of a torch checkpoint (its ``state_dict`` entry where
    it has one) as numpy arrays. The file is unpickled
    (``weights_only=False``, as Lightning checkpoints need), which runs any
    code the pickle holds: read only checkpoints you trust."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _state_dict(src: Union[str, Mapping]) -> StateDict:
    return dict(src) if isinstance(src, Mapping) else \
        load_torch_state_dict(src)


def numpy_tree(tree: Mapping) -> dict:
    """A copy of a nested dict of arrays, numpy leaves."""
    return {k: numpy_tree(v) if isinstance(v, Mapping) else np.array(v)
            for k, v in tree.items()}


def _filter_keys(sd: StateDict, ignore_keys: Sequence[str]) -> StateDict:
    """Drop the keys under any prefix of ``ignore_keys``, saying so."""
    out = {}
    for k, v in sd.items():
        if any(k.startswith(ik) for ik in ignore_keys):
            print(f"Deleting key {k} from state_dict.")
            continue
        out[k] = v
    return out


def _set(params: Dict, path: List[str], value: np.ndarray) -> bool:
    node = params
    for p in path[:-1]:
        if p not in node:
            return False
        node = node[p]
    if path[-1] not in node:
        return False
    expected = np.shape(node[path[-1]])
    if tuple(expected) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"ckpt {value.shape} vs model {expected}")
    node[path[-1]] = value.astype(np.asarray(node[path[-1]]).dtype)
    return True


# reference per-layer key suffix -> (path inside a block, transpose?)
_VIT_BLOCK_MAP = {
    ("0", "norm.weight"): (["norm1", "scale"], False),
    ("0", "norm.bias"): (["norm1", "bias"], False),
    ("0", "fn.to_qkv.weight"): (["attn", "to_qkv", "kernel"], True),
    ("0", "fn.to_out.weight"): (["attn", "to_out", "kernel"], True),
    ("0", "fn.to_out.bias"): (["attn", "to_out", "bias"], False),
    ("1", "norm.weight"): (["norm2", "scale"], False),
    ("1", "norm.bias"): (["norm2", "bias"], False),
    ("1", "fn.net.0.weight"): (["ff", "fc1", "kernel"], True),
    ("1", "fn.net.0.bias"): (["ff", "fc1", "bias"], False),
    ("1", "fn.net.2.weight"): (["ff", "fc2", "kernel"], True),
    ("1", "fn.net.2.bias"): (["ff", "fc2", "bias"], False),
}


def _map_vit_transformer(prefix: str, sd, params, out_prefix: List[str],
                         loaded: set) -> None:
    """Map a stage-1 Transformer stack (encoder/decoder.transformer.*), in
    the per-layer layout (``layers_{i}``) or stacked (``layers`` with a
    leading layer axis)."""
    node = params
    for p in out_prefix:
        node = node.get(p, {})
    stacked = "layers" in node

    layer_pat = re.compile(
        re.escape(prefix) + r"\.layers\.(\d+)\.(\d)\.(.+)$")
    per_layer: Dict[str, Dict[int, np.ndarray]] = {}
    for key, val in sd.items():
        m = layer_pat.match(key)
        if m:
            i, branch, rest = int(m.group(1)), m.group(2), m.group(3)
            mapping = _VIT_BLOCK_MAP.get((branch, rest))
            if mapping is None:
                continue
            path, transpose = mapping
            v = val.T if transpose else val
            if stacked:
                per_layer.setdefault("/".join(path), {})[i] = v
                loaded.add(key)
            else:
                if _set(params, out_prefix + [f"layers_{i}"] + path, v):
                    loaded.add(key)
        elif key == f"{prefix}.norm.weight":
            if _set(params, out_prefix + ["norm", "scale"], val):
                loaded.add(key)
        elif key == f"{prefix}.norm.bias":
            if _set(params, out_prefix + ["norm", "bias"], val):
                loaded.add(key)

    for path_str, by_idx in per_layer.items():
        vals = np.stack([by_idx[i] for i in sorted(by_idx)], axis=0)
        _set(params, out_prefix + ["layers"] + path_str.split("/"), vals)


def load_vitvq_params(path: Union[str, Mapping], params: Mapping,
                      ignore_keys: Sequence[str] = ()) -> dict:
    """A copy of the ViTVQ tree ``params`` with the reference checkpoint's
    weights mapped in."""
    sd = _filter_keys(_state_dict(path), ignore_keys)
    params = numpy_tree(params)
    loaded: set = set()

    # patch embedding conv
    if "encoder.to_patch_embedding.0.weight" in sd:
        w = sd["encoder.to_patch_embedding.0.weight"]   # (dim, c, p, p)
        _set(params, ["encoder", "patch_embed", "kernel"],
             w.reshape(w.shape[0], -1).T)
        _set(params, ["encoder", "patch_embed", "bias"],
             sd["encoder.to_patch_embedding.0.bias"])
        loaded |= {"encoder.to_patch_embedding.0.weight",
                   "encoder.to_patch_embedding.0.bias"}

    # pixel un-embedding transposed conv
    if "decoder.to_pixel.1.weight" in sd:
        w = sd["decoder.to_pixel.1.weight"]             # (dim, c, p, p)
        _set(params, ["decoder", "to_pixel", "kernel"],
             w.reshape(w.shape[0], -1))
        b = sd["decoder.to_pixel.1.bias"]               # (c,) per channel
        pp = w.shape[2] * w.shape[3]
        _set(params, ["decoder", "to_pixel", "bias"], np.repeat(b, pp))
        loaded |= {"decoder.to_pixel.1.weight", "decoder.to_pixel.1.bias"}

    _map_vit_transformer("encoder.transformer", sd, params,
                         ["encoder", "transformer"], loaded)
    _map_vit_transformer("decoder.transformer", sd, params,
                         ["decoder", "transformer"], loaded)

    for src, dst in [("pre_quant", "pre_quant"), ("post_quant", "post_quant")]:
        if f"{src}.weight" in sd:
            _set(params, [dst, "kernel"], sd[f"{src}.weight"].T)
            _set(params, [dst, "bias"], sd[f"{src}.bias"])
            loaded |= {f"{src}.weight", f"{src}.bias"}

    if "quantizer.embedding.weight" in sd:
        _set(params, ["quantizer", "embedding"],
             sd["quantizer.embedding.weight"])
        loaded.add("quantizer.embedding.weight")

    skipped = [k for k in sd if k not in loaded
               and not k.startswith("loss.")
               and "pos_embedding" not in k]  # pos embeds are recomputed
    if skipped:
        print(f"torch_loader: {len(skipped)} unmapped keys "
              f"(e.g. {skipped[:5]})")
    return params


def load_gpt_params(path: Union[str, Mapping], params: Mapping,
                    ignore_keys: Sequence[str] = ()) -> dict:
    """A copy of the GPT or RQTransformer tree ``params`` with the
    reference checkpoint's weights mapped in; a stage-2 Lightning
    checkpoint's ``transformer.`` prefix is stripped (its other keys
    dropped)."""
    sd = _filter_keys(_state_dict(path), ignore_keys)
    if any(k.startswith("transformer.") for k in sd):
        sd = {k[len("transformer."):]: v for k, v in sd.items()
              if k.startswith("transformer.")}
    params = numpy_tree(params)
    loaded: set = set()

    def linear(src: str, dst: List[str]):
        if f"{src}.weight" in sd:
            if _set(params, dst + ["kernel"], sd[f"{src}.weight"].T):
                loaded.add(f"{src}.weight")
        if f"{src}.bias" in sd:
            if _set(params, dst + ["bias"], sd[f"{src}.bias"]):
                loaded.add(f"{src}.bias")

    for emb in ("tok_emb_cond", "tok_emb_code"):
        if f"{emb}.weight" in sd:
            _set(params, [emb, "embedding"], sd[f"{emb}.weight"])
            loaded.add(f"{emb}.weight")
    for pos in ("pos_emb_cond", "pos_emb_code", "pos_emb_depth"):
        if pos in sd:
            _set(params, [pos], sd[pos])
            loaded.add(pos)

    table = {
        "ln1.weight": (["ln1", "scale"], None),
        "ln1.bias": (["ln1", "bias"], None),
        "ln2.weight": (["ln2", "scale"], None),
        "ln2.bias": (["ln2", "bias"], None),
        "attn.time_mix": (["attn", "time_mix"], None),
    }
    for proj in ("key", "query", "value", "proj"):
        table[f"attn.{proj}.weight"] = (["attn", proj, "kernel"], "T")
        table[f"attn.{proj}.bias"] = (["attn", proj, "bias"], None)
    for p in ("p0", "p1"):
        table[f"mlp.{p}.weight"] = (["mlp", p, "kernel"], "T")
        table[f"mlp.{p}.bias"] = (["mlp", p, "bias"], None)

    block_maps = [("blocks", "blocks"), ("spatial_transformer", "spatial"),
                  ("depth_transformer", "depth")]
    for src_stack, dst_stack in block_maps:
        pat = re.compile(re.escape(src_stack) + r"\.(\d+)\.(.+)$")
        per_layer: Dict[str, Dict[int, np.ndarray]] = {}
        for key in sd:
            m = pat.match(key)
            if not m:
                continue
            i, rest = int(m.group(1)), m.group(2)
            mapping = table.get(rest)
            if mapping is None:
                continue
            path, tf = mapping
            val = sd[key].T if tf == "T" else sd[key]
            per_layer.setdefault("/".join(path), {})[i] = val
            loaded.add(key)
        if not per_layer:
            continue
        stacked_layout = dst_stack in params  # scan-over-layers tree
        for path_str, by_idx in per_layer.items():
            path = path_str.split("/")
            vals = [by_idx[i] for i in sorted(by_idx)]
            if stacked_layout:
                _set(params, [dst_stack] + path, np.stack(vals, axis=0))
            else:
                for i, v in zip(sorted(by_idx), vals):
                    _set(params, [f"{dst_stack}_{i}"] + path, v)

    for ln in ("layer_norm", "ln_spatial", "ln_depth"):
        if f"{ln}.weight" in sd:
            _set(params, [ln, "scale"], sd[f"{ln}.weight"])
            _set(params, [ln, "bias"], sd[f"{ln}.bias"])
            loaded |= {f"{ln}.weight", f"{ln}.bias"}
    linear("head", ["head"])

    skipped = [k for k in sd if k not in loaded and ".mask" not in k]
    if skipped:
        print(f"torch_loader: {len(skipped)} unmapped keys "
              f"(e.g. {skipped[:5]})")
    return params


def load_style_discriminator_params(path: Union[str, Mapping],
                                    params: Mapping, size: int = 256,
                                    ignore_keys: Sequence[str] = ()) -> dict:
    """A copy of the StyleDiscriminator tree ``params`` with the
    checkpoint's ``loss.discriminator.*`` weights (or a bare
    discriminator's state dict) mapped in.

    Reference layout: ``blocks.0`` the stem [EqualConv2d,
    FusedLeakyReLU]; ``blocks.j`` (j >= 1) StyleBlocks {conv1,
    conv2 (downsampling), skip}; ``final_conv``; ``final_linear.{0,1}``.
    The JAX tree: ``stem`` / ``block_{res_log2}`` / ``final_conv`` /
    ``final_linear{1,2}``, HWIO conv weights and (in, out) linear weights.
    """
    sd = _filter_keys(_state_dict(path), ignore_keys)
    disc = {k[len("loss.discriminator."):]: v for k, v in sd.items()
            if k.startswith("loss.discriminator.")}
    if not disc:
        disc = sd  # already a bare discriminator state_dict
    params = numpy_tree(params)
    loaded: set = set()

    def conv_w(v):   # (out, in, k, k) -> (k, k, in, out)
        return np.transpose(v, (2, 3, 1, 0))

    def put(dst, key, tf=None):
        if key in disc:
            val = disc[key]
            if tf is not None:
                val = tf(val)
            if _set(params, dst, val):
                loaded.add(key)

    put(["stem", "conv", "weight"], "blocks.0.0.weight", conv_w)
    put(["stem", "act_bias"], "blocks.0.1.bias")

    log_size = int(math.log2(size))
    for j in range(1, log_size - 1):        # StyleBlocks
        res = log_size - (j - 1)
        base = [f"block_{res}"]
        put(base + ["conv1", "conv", "weight"], f"blocks.{j}.conv1.0.weight",
            conv_w)
        put(base + ["conv1", "act_bias"], f"blocks.{j}.conv1.1.bias")
        put(base + ["conv2", "conv", "weight"], f"blocks.{j}.conv2.1.weight",
            conv_w)
        put(base + ["conv2", "act_bias"], f"blocks.{j}.conv2.2.bias")
        put(base + ["skip", "conv", "weight"], f"blocks.{j}.skip.1.weight",
            conv_w)

    put(["final_conv", "conv", "weight"], "final_conv.0.weight", conv_w)
    put(["final_conv", "act_bias"], "final_conv.1.bias")
    put(["final_linear1", "weight"], "final_linear.0.weight", np.transpose)
    put(["final_linear1", "bias"], "final_linear.0.bias")
    put(["final_linear2", "weight"], "final_linear.1.weight", np.transpose)
    put(["final_linear2", "bias"], "final_linear.1.bias")

    skipped = [k for k in disc if k not in loaded and ".kernel" not in k]
    if skipped:
        print(f"torch_loader(disc): {len(skipped)} unmapped keys "
              f"(e.g. {skipped[:4]})")
    return params
