"""OpenAI CLIP (ViT vision tower + causal text tower) in PyTorch.

Counterpart of ``enhancing_tpu/models/cond/clip.py``; the submodules are
named after the JAX trees (``resblocks_{i}``, ``ln_1``, ``in_proj``,
``out_proj``, ``ln_2``, ``c_fc``, ``c_proj``), so ``compat.from_jax``
carries JAX parameters across (:func:`~..compat.from_jax.load_clip_from_jax`):

- :class:`CLIPVisionTransformer`: conv patch embedding (no bias), class
  token, position embedding sized from the resolution, pre-LN
  transformer, ``ln_post`` and the projection.
- :class:`CLIPTextTransformer`: token + position embeddings, causal
  transformer, ``ln_final``, the features at the first maximum token id
  (EOT), projected.
- :class:`ResidualAttentionBlock`: ``ln_1`` -> ``in_proj`` ->
  ``ops.attention.multihead_attention_bnhd`` (B8 on the card) ->
  ``out_proj``; ``ln_2`` -> ``c_fc`` -> QuickGELU -> ``c_proj``.

The LayerNorms, Dense layers, QuickGELU, ``conv1`` and the resize are
library and plain ops here, as they are ``flax.linen`` ops outside any
Pallas kernel in the JAX package. Parameters are fp32; ``dtype`` is the
compute dtype, as a flax module's ``dtype``.

:func:`load_torch_clip` reads an OpenAI checkpoint (the state dict of
``clip.load(...)``, or a Hugging Face one with ``clip.``-prefixed OpenAI
key names) into the towers; :func:`clip_config_from_state_dict` infers
the architecture from the checkpoint's shapes as ``clip/model.py``'s
``build_model`` does. No weights ship with the repository.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import multihead_attention_bnhd
from ...ops.common import resolve_device
from ..stage1.layers import Dense
from ..stage1.vitvqgan import DTYPES
from ..stage2.layers import LayerNorm

# CLIP preprocess normalization (clip/clip.py _transform)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # real CLIP always uses vision_width // 64 heads; overridable for tests
    vision_heads_override: Optional[int] = None

    @property
    def vision_heads(self) -> int:
        return self.vision_heads_override or self.vision_width // 64


# the ViT model family's shapes (clip/model.py), by the names clip.load takes
CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig(),
    "ViT-B/16": CLIPConfig(vision_patch_size=16),
    "ViT-L/14": CLIPConfig(embed_dim=768, vision_layers=24, vision_width=1024,
                           vision_patch_size=14, transformer_width=768,
                           transformer_heads=12),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(width: int, dtype: torch.dtype) -> LayerNorm:
    ln = LayerNorm(width, dtype=dtype)
    nn.init.ones_(ln.weight)
    nn.init.zeros_(ln.bias)
    return ln


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.heads, self.causal = heads, causal
        dense = dict(dtype=dtype, generator=generator)
        self.ln_1 = _layer_norm(width, dtype)
        self.in_proj = Dense(width, 3 * width, **dense)
        self.out_proj = Dense(width, width, **dense)
        self.ln_2 = _layer_norm(width, dtype)
        self.c_fc = Dense(width, 4 * width, **dense)
        self.c_proj = Dense(4 * width, width, **dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.heads
        qkv = self.in_proj(self.ln_1(x))
        # q, k and v stay lane slices of the qkv buffer: B8 reads them
        # through its strides
        q, k, v = (u.reshape(b, t, self.heads, hd)
                   for u in qkv.split(c, dim=-1))
        y = multihead_attention_bnhd(
            q, k, v, scale=hd ** -0.5,
            mask_mode="prefix_causal" if self.causal else "none", cond_len=0)
        x = x + self.out_proj(y.reshape(b, t, c))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class _Tower(nn.Module):
    """Blocks ``resblocks_0`` ... and where they run."""

    def __init__(self, width: int, heads: int, layers: int, causal: bool,
                 dtype: str, generator: torch.Generator) -> None:
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[dtype]
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resblocks_{i}", ResidualAttentionBlock(
                width, heads, causal, dtype=self.dtype, generator=generator))

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"resblocks_{i}")(x)
        return x


class CLIPVisionTransformer(_Tower):
    """Images (B, H, W, 3), CLIP-normalized at the configured resolution,
    -> (B, embed_dim) features. Random weights are drawn on ``device``
    (default ``cuda``) from a generator seeded with ``seed``."""

    def __init__(self, config: CLIPConfig, dtype: str = "float32",
                 seed: int = 0,
                 device: str | torch.device | None = None) -> None:
        cfg = config
        w, p = cfg.vision_width, cfg.vision_patch_size
        dev = resolve_device(device)
        gen, scale = torch.Generator(dev).manual_seed(seed), w ** -0.5
        with torch.device(dev):
            super().__init__(w, cfg.vision_heads, cfg.vision_layers, False,
                             dtype, gen)
            self.conv1 = nn.Conv2d(3, w, p, p, bias=False, device="meta")
            self.conv1.weight = _normal((w, 3, p, p), (3 * p * p) ** -0.5,
                                        gen)
            grid = cfg.image_resolution // p
            self.class_embedding = _normal((w,), scale, gen)
            self.positional_embedding = _normal((grid * grid + 1, w), scale,
                                                gen)
            self.ln_pre = _layer_norm(w, self.dtype)
            self.ln_post = _layer_norm(w, self.dtype)
            self.proj = _normal((w, cfg.embed_dim), scale, gen)
        self.config = cfg
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt, p = self.dtype, self.config.vision_patch_size
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     self.conv1.weight.to(dt), stride=p)
        x = x.flatten(2).transpose(1, 2)                   # (B, N, W)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.blocks(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj.to(dt)


class CLIPTextTransformer(_Tower):
    """Tokens (B, T <= context_length) -> (B, embed_dim) features at the
    first maximum token id of each row (the EOT token of a CLIP caption).
    Random weights are drawn on ``device`` (default ``cuda``) from a
    generator seeded with ``seed``."""

    def __init__(self, config: CLIPConfig, dtype: str = "float32",
                 seed: int = 0,
                 device: str | torch.device | None = None) -> None:
        cfg = config
        w, v = cfg.transformer_width, cfg.vocab_size
        dev = resolve_device(device)
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device(dev):
            super().__init__(w, cfg.transformer_heads,
                             cfg.transformer_layers, True, dtype, gen)
            self.token_embedding = nn.Embedding(
                v, w, _weight=_normal((v, w), 0.02, gen))
            self.positional_embedding = _normal((cfg.context_length, w),
                                                0.01, gen)
            self.ln_final = _layer_norm(w, self.dtype)
            self.text_projection = _normal((w, cfg.embed_dim), w ** -0.5,
                                           gen)
        self.config = cfg
        self.eval()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt, t = self.dtype, tokens.shape[1]
        x = self.token_embedding(tokens).to(dt)
        x = x + self.positional_embedding[:t].to(dt)
        x = self.ln_final(self.blocks(x))
        eot = tokens.argmax(dim=-1)     # the first maximum, as jnp.argmax
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(dt)


def preprocess_images(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """[0, 1] NHWC images -> CLIP-normalized at the tower's resolution.
    The resize is bicubic with antialiasing, as ``jax.image.resize(...,
    "bicubic")`` computes it (Keys' a = -0.5; the kernel widened by the
    scale when shrinking)."""
    b, h, w, c = images.shape
    if (h, w) != (resolution, resolution):
        images = F.interpolate(
            images.permute(0, 3, 1, 2), size=(resolution, resolution),
            mode="bicubic", antialias=True, align_corners=False,
        ).permute(0, 2, 3, 1)
    mean, std = (torch.tensor(a, device=images.device)
                 for a in (CLIP_MEAN, CLIP_STD))
    return (images - mean) / std


# ---------------------------------------------------------------------------
# OpenAI checkpoints
# ---------------------------------------------------------------------------


def clip_config_from_state_dict(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """The hyperparameters a checkpoint's shapes imply (clip/model.py
    ``build_model``, ViT branch)."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks.")}),
    )


def _map_resblocks(sd: Dict[str, np.ndarray], prefix: str, params: dict,
                   n_layers: int, unused: set) -> None:
    for i in range(n_layers):
        src = f"{prefix}resblocks.{i}."
        dst = params[f"resblocks_{i}"]
        pairs = [
            (src + "ln_1.weight", dst["ln_1"], "scale", None),
            (src + "ln_1.bias", dst["ln_1"], "bias", None),
            (src + "ln_2.weight", dst["ln_2"], "scale", None),
            (src + "ln_2.bias", dst["ln_2"], "bias", None),
            (src + "attn.in_proj_weight", dst["in_proj"], "kernel", "T"),
            (src + "attn.in_proj_bias", dst["in_proj"], "bias", None),
            (src + "attn.out_proj.weight", dst["out_proj"], "kernel", "T"),
            (src + "attn.out_proj.bias", dst["out_proj"], "bias", None),
            (src + "mlp.c_fc.weight", dst["c_fc"], "kernel", "T"),
            (src + "mlp.c_fc.bias", dst["c_fc"], "bias", None),
            (src + "mlp.c_proj.weight", dst["c_proj"], "kernel", "T"),
            (src + "mlp.c_proj.bias", dst["c_proj"], "bias", None),
        ]
        for key, node, leaf, tf in pairs:
            w = np.asarray(sd[key], np.float32)
            node[leaf] = w.T if tf == "T" else w
            unused.discard(key)


def load_clip_vision_params(sd: Dict[str, np.ndarray], params: dict,
                            cfg: CLIPConfig) -> Tuple[dict, set]:
    """A copy of the vision tower's JAX-named tree ``params`` with the
    ``visual.*`` keys mapped in, and the set of keys consumed."""
    from ...compat.torch_loader import numpy_tree
    params = numpy_tree(params)
    vis = {k[len("visual."):]: v for k, v in sd.items()
           if k.startswith("visual.")}
    unused = set(vis)
    # torch conv weight (out, in, kh, kw) -> flax (kh, kw, in, out)
    params["conv1"]["kernel"] = np.asarray(
        vis["conv1.weight"], np.float32).transpose(2, 3, 1, 0)
    params["class_embedding"] = np.asarray(vis["class_embedding"], np.float32)
    params["positional_embedding"] = np.asarray(
        vis["positional_embedding"], np.float32)
    params["proj"] = np.asarray(vis["proj"], np.float32)
    for ln in ("ln_pre", "ln_post"):
        params[ln]["scale"] = np.asarray(vis[f"{ln}.weight"], np.float32)
        params[ln]["bias"] = np.asarray(vis[f"{ln}.bias"], np.float32)
    unused -= {"conv1.weight", "class_embedding", "positional_embedding",
               "proj", "ln_pre.weight", "ln_pre.bias", "ln_post.weight",
               "ln_post.bias"}
    _map_resblocks(vis, "transformer.", params, cfg.vision_layers, unused)
    consumed = {"visual." + k for k in set(vis) - unused}
    return params, consumed


def load_clip_text_params(sd: Dict[str, np.ndarray], params: dict,
                          cfg: CLIPConfig) -> Tuple[dict, set]:
    """A copy of the text tower's JAX-named tree ``params`` with the text
    keys mapped in, and the set of keys consumed."""
    from ...compat.torch_loader import numpy_tree
    params = numpy_tree(params)
    unused = {k for k in sd if not k.startswith("visual.")}
    params["token_embedding"]["embedding"] = np.asarray(
        sd["token_embedding.weight"], np.float32)
    params["positional_embedding"] = np.asarray(
        sd["positional_embedding"], np.float32)
    params["text_projection"] = np.asarray(sd["text_projection"], np.float32)
    params["ln_final"]["scale"] = np.asarray(sd["ln_final.weight"], np.float32)
    params["ln_final"]["bias"] = np.asarray(sd["ln_final.bias"], np.float32)
    unused -= {"token_embedding.weight", "positional_embedding",
               "text_projection", "ln_final.weight", "ln_final.bias",
               "logit_scale"}
    _map_resblocks(sd, "transformer.", params, cfg.transformer_layers, unused)
    consumed = {k for k in sd if not k.startswith("visual.")} - unused
    return params, consumed


def load_torch_clip(path: str, which: str = "both",
                    cfg: Optional[CLIPConfig] = None,
                    device: str | torch.device | None = None
                    ) -> Tuple[CLIPConfig, Dict[str, Any]]:
    """(config, towers) of an OpenAI CLIP torch checkpoint: ``which`` is
    'visual', 'text' or 'both'; the dict holds the fp32 towers under
    'visual' / 'text', on ``device`` (default ``cuda``). The checkpoint is
    unpickled (``compat.torch_loader.load_torch_state_dict``)."""
    from ...compat.from_jax import load_clip_from_jax, to_jax_tree
    from ...compat.torch_loader import load_torch_state_dict
    sd = load_torch_state_dict(path)
    # clip.load() checkpoints are the full model; HF ones may nest
    sd = {k[len("clip."):] if k.startswith("clip.") else k: v
          for k, v in sd.items()}
    if cfg is None:
        cfg = clip_config_from_state_dict(sd)
    out: Dict[str, Any] = {}
    towers = {"visual": (CLIPVisionTransformer, load_clip_vision_params),
              "text": (CLIPTextTransformer, load_clip_text_params)}
    for name, (tower, load) in towers.items():
        if which in (name, "both"):
            module = tower(cfg, device=device)
            params, _ = load(sd, to_jax_tree(module), cfg)
            out[name] = load_clip_from_jax(module, params)
    return cfg, out
