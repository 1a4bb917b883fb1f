"""ViT-VQGAN stage-1 tokenizer: encoder -> pre_quant -> quantizer ->
post_quant -> decoder, in PyTorch.

Counterpart of ``enhancing_tpu/models/stage1/vitvqgan.py``:

- :class:`ViTVQModule` is the ``nn.Module`` with ``forward / encode /
  decode / encode_codes / decode_codes / forward_training``. Encode runs
  the quantizer in fp32; decode casts ``quant`` to the compute dtype
  before ``post_quant``.
- :class:`ViTVQ` / :class:`ViTVQGumbel` are the config-instantiable
  wrappers: they build the module from a seed on the chosen device and
  serve it under ``torch.inference_mode()``; ``train.Trainer`` trains the
  module in train mode outside it. Images are NHWC; NCHW input is
  transposed.

The constructor takes the JAX wrapper's config keys and builds ``loss``
and ``temperature_scheduler`` with ``initialize_from_config``, as the JAX
wrapper does; the loss moves to the model's device. ``remat`` and
``scan_layers`` choose how XLA compiles the JAX model and mean nothing to
eager PyTorch. ``path=`` restores a reference (Lightning) checkpoint,
the loss's StyleGAN discriminator included, through
``compat.torch_loader``; weights come across from a JAX parameter tree
through ``compat.from_jax.load_vitvq_from_jax``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.common import resolve_device
from ...utils.config import initialize_from_config
from .layers import Dense, ViTDecoder, ViTEncoder
from .quantizers import GumbelQuantizer, VectorQuantizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ViTVQModule(nn.Module):
    """The ViT-VQGAN autoencoder core."""

    def __init__(self, image_size: int, patch_size: int,
                 encoder: Dict[str, Any], decoder: Dict[str, Any],
                 quantizer: Dict[str, Any], quantizer_type: str = "vq", *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.quantizer_type = quantizer_type
        self.encoder = ViTEncoder(image_size, patch_size, dtype=dtype,
                                  generator=generator, **encoder)
        self.decoder = ViTDecoder(image_size, patch_size, dtype=dtype,
                                  generator=generator, **decoder)
        if quantizer_type == "vq":
            self.quantizer = VectorQuantizer(generator=generator, **quantizer)
        elif quantizer_type == "gumbel":
            self.quantizer = GumbelQuantizer(generator=generator, **quantizer)
        else:
            raise ValueError(f"unknown quantizer_type {quantizer_type!r}")
        embed_dim = quantizer["embed_dim"]
        self.pre_quant = Dense(encoder["dim"], embed_dim, dtype=dtype,
                               generator=generator)
        self.post_quant = Dense(embed_dim, decoder["dim"], dtype=dtype,
                                generator=generator)

    def forward(self, x: torch.Tensor, temp: Optional[float] = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        quant, diff = self.encode(x, temp, deterministic, generator)
        return self.decode(quant), diff

    def _run_quantizer(self, h, temp=None, deterministic=True, generator=None):
        if self.quantizer_type == "gumbel":
            return self.quantizer(h, temp, deterministic, generator)
        return self.quantizer(h)

    def encode(self, x: torch.Tensor, temp: Optional[float] = None,
               deterministic: bool = True,
               generator: torch.Generator | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.pre_quant(self.encoder(x))
        quant, emb_loss, _ = self._run_quantizer(h.float(), temp,
                                                 deterministic, generator)
        return quant, emb_loss

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant(quant.to(self.dtype)))

    def encode_codes(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pre_quant(self.encoder(x))
        _, _, codes = self._run_quantizer(h.float())
        return codes

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantizer.embed_codes(codes))

    def forward_training(self, x: torch.Tensor, temp: Optional[float] = None,
                         deterministic: bool = True,
                         generator: torch.Generator | None = None):
        """(xrec, qloss, pre_pixel_tokens, codes) in one pass: the tokens
        let the train step form last-layer gradients for the adaptive
        adversarial weight, the codes its codebook-usage metrics."""
        h = self.pre_quant(self.encoder(x))
        quant, emb_loss, codes = self._run_quantizer(h.float(), temp,
                                                     deterministic, generator)
        tokens = self.decoder.pre_pixel_tokens(
            self.post_quant(quant.to(self.dtype)))
        return self.decoder.pixels_from_tokens(tokens), emb_loss, tokens, codes


def as_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Accept NCHW (the original PyTorch layout) or NHWC; return NHWC."""
    if x.ndim == 3:
        x = x[..., None]
    if x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.permute(0, 2, 3, 1)
    return x


class ViTVQ:
    """Config-instantiable stage-1 tokenizer owning a :class:`ViTVQModule`.

    ``device`` defaults to ``cuda``; pass ``device="cpu"`` for the plain
    versions. ``dtype`` is ``"float32"`` or ``"bfloat16"``; random weights
    come from ``torch.Generator().manual_seed(seed)``.
    """

    quantizer_type = "vq"

    def __init__(self, image_key: str = "image", image_size: int = 256,
                 patch_size: int = 8, encoder: Optional[dict] = None,
                 decoder: Optional[dict] = None,
                 quantizer: Optional[dict] = None, loss: Optional[dict] = None,
                 path: Optional[str] = None, ignore_keys: Sequence[str] = (),
                 scheduler: Optional[dict] = None, dtype: str = "float32",
                 seed: int = 0, remat: bool = False, scan_layers: bool = False,
                 temperature_scheduler: Optional[dict] = None,
                 device: str | torch.device | None = None) -> None:
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
        self.device = resolve_device(device)
        self.image_key = image_key
        self.image_size = image_size
        self.patch_size = patch_size
        self.scheduler = scheduler
        self.temperature_scheduler = (
            initialize_from_config(temperature_scheduler)
            if temperature_scheduler else None)
        self.loss = (initialize_from_config(loss).to(self.device)
                     if loss else None)
        self.dtype = DTYPES[dtype]
        generator = torch.Generator().manual_seed(seed)
        self.module = ViTVQModule(
            image_size, patch_size, dict(encoder or {}), dict(decoder or {}),
            dict(quantizer or {}), self.quantizer_type, dtype=self.dtype,
            generator=generator).to(self.device).eval()
        if path is not None:
            self.init_from_ckpt(path, list(ignore_keys))

    def init_from_ckpt(self, path: str, ignore_keys: Sequence[str] = ()
                       ) -> None:
        """Restore a reference (Lightning) checkpoint: the tokenizer's
        weights and, where the model's loss holds the StyleGAN
        discriminator and the file has ``loss.discriminator.*``, the
        discriminator's. Keys under a prefix of ``ignore_keys`` are dropped
        (each printed) and keep this model's values."""
        from ...compat.from_jax import (load_style_discriminator_from_jax,
                                        load_vitvq_from_jax, to_jax_tree)
        from ...compat.torch_loader import (load_style_discriminator_params,
                                            load_torch_state_dict,
                                            load_vitvq_params)
        sd = load_torch_state_dict(path)
        load_vitvq_from_jax(self, load_vitvq_params(
            sd, to_jax_tree(self.module), ignore_keys))
        if (getattr(self.loss, "has_discriminator", False)
                and any(k.startswith("loss.discriminator.") for k in sd)):
            disc = self.loss.discriminator
            load_style_discriminator_from_jax(
                disc, load_style_discriminator_params(
                    sd, to_jax_tree(disc), size=self.image_size,
                    ignore_keys=ignore_keys))
        print(f"Restored from {path}")

    def _tensor(self, x, dtype: torch.dtype | None = None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))  # a copy: arrays may be read-only
        return x.to(device=self.device, dtype=dtype)

    def _images(self, x) -> torch.Tensor:
        return as_nhwc(self._tensor(x, torch.float32))

    @torch.inference_mode()
    def __call__(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(reconstruction, quantizer loss) of images ``x``."""
        return self.module(self._images(x))

    @torch.inference_mode()
    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.module.encode(self._images(x))

    @torch.inference_mode()
    def decode(self, quant) -> torch.Tensor:
        return self.module.decode(self._tensor(quant))

    @torch.inference_mode()
    def encode_codes(self, x) -> torch.Tensor:
        """Images (B, H, W, C) in [0, 1] -> int32 codes (B, N)."""
        return self.module.encode_codes(self._images(x))

    @torch.inference_mode()
    def decode_codes(self, codes) -> torch.Tensor:
        """Codes (B, N) -> images (B, H, W, C) in the compute dtype."""
        return self.module.decode_codes(self._tensor(codes))

    def get_input(self, batch: dict, key: str = "image") -> torch.Tensor:
        return self._images(batch[key])

    def log_images(self, batch: dict, **kwargs) -> Dict[str, torch.Tensor]:
        x = self.get_input(batch, self.image_key)
        quant, _ = self.encode(x)
        return {"originals": x, "reconstructions": self.decode(quant)}


class ViTVQGumbel(ViTVQ):
    """ViTVQ with the Gumbel-softmax quantizer: deterministic when serving;
    ``train.Trainer`` trains it on Gumbel noise at the temperature its
    ``temperature_scheduler`` gives each step."""

    quantizer_type = "gumbel"
