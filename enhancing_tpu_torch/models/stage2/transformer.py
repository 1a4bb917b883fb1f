"""Conditional stage-2 model: condition encoder + frozen stage-1 + prior.

Counterpart of ``enhancing_tpu/models/stage2/transformer.py``
(``CondTransformer``, ``:23-158``): it builds the condition model, the
frozen stage-1 tokenizer and the prior from a config, a GPT over (B, T)
codes or, when the transformer's target is ``RQTransformer``, an RQ prior
over (B, T, D) residual codes of an RQ-VAE tokenizer (``is_rq``);
``loss_fn`` is the prior's cross-entropy on the codes of a batch;
``sample`` draws codes on the device (``sample_gpt`` or ``sample_rq``) and
decodes them to pixels in [0, 1].

``path=`` restores the prior from a reference checkpoint
(``compat.torch_loader``); ``mesh=`` data-parallel sampling (ROADMAP A9)
is a later slice and raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.common import resolve_device
from ...utils.config import initialize_from_config
from .layers import GPT, RQTransformer
from .sampling import sample_gpt, sample_rq


class CondTransformer:
    """Config-instantiable conditional prior over tokenizer codes.

    ``device`` (default ``cuda``) is passed to the stage-1 model and the
    prior; ``dtype`` is the prior's compute dtype unless its own params
    name one. Random weights come from ``seed``.
    """

    def __init__(self, cond_key: str, cond: dict, stage1: dict,
                 transformer: dict, path: Optional[str] = None,
                 ignore_keys: Sequence[str] = (),
                 code_shape: Optional[List[int]] = None,
                 scheduler: Optional[dict] = None, dtype: str = "float32",
                 seed: int = 0,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.cond_key = cond_key
        self.code_shape = code_shape
        self.scheduler = scheduler
        self.cond_model = initialize_from_config(cond)
        self.stage1_model = initialize_from_config(stage1, device=self.device)
        tconf = dict(transformer.get("params", {}) or {})
        tconf.setdefault("dtype", dtype)
        self.is_rq = transformer["target"].rsplit(".", 1)[-1] == \
            "RQTransformer"
        prior = RQTransformer if self.is_rq else GPT
        self.transformer = prior(**tconf, device=self.device, seed=seed)
        if path is not None:
            self.init_from_ckpt(path, list(ignore_keys))

    def init_from_ckpt(self, path: str, ignore_keys: Sequence[str] = ()
                       ) -> None:
        """Restore the prior from a reference checkpoint (a stage-2
        Lightning file, whose ``transformer.`` keys are the prior's, or
        the prior's own state dict). Keys under a prefix of
        ``ignore_keys`` are dropped (each printed) and keep this model's
        values."""
        from ...compat.from_jax import (load_gpt_from_jax, load_rq_from_jax,
                                        to_jax_tree)
        from ...compat.torch_loader import load_gpt_params
        load = load_rq_from_jax if self.is_rq else load_gpt_from_jax
        load(self.transformer, load_gpt_params(
            path, to_jax_tree(self.transformer), ignore_keys))
        print(f"Restored from {path}")

    # -- the prior's forward and loss -----------------------------------------

    def _ids(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        return x.to(self.device).long()

    def __call__(self, codes, conds) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, target codes) of the teacher-forced forward: (B, T, V)
        and (B, T) for a GPT prior, (B * T, D, V) and (B * T, D) for an RQ
        prior."""
        codes, conds = self._ids(codes), self._ids(conds)
        conds = conds.reshape(conds.shape[0], -1)
        logits = self.transformer(codes, conds)
        if self.is_rq:
            return logits, codes.reshape(-1, codes.shape[-1])
        return logits, codes.reshape(codes.shape[0], -1)

    def loss_fn(self, codes, conds) -> torch.Tensor:
        """Mean cross-entropy of the prior's predictions, in fp32."""
        logits, targets = self(codes, conds)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               targets.reshape(-1))

    def encode_inputs(self, batch: Dict[str, Any]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen encodes: images -> codes, condition -> condition codes."""
        images = self.stage1_model.get_input(batch,
                                             self.stage1_model.image_key)
        return (self.stage1_model.encode_codes(images),
                self.condition_codes(batch))

    def condition_codes(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The (B, T) int32 condition codes of a batch on the device."""
        cond_codes = self._ids(self.cond_model.encode_codes(
            batch[self.cond_key]))
        if cond_codes.ndim == 1:
            cond_codes = cond_codes[:, None]
        # an out-of-vocabulary condition id would gather garbage: fail on
        # the host instead
        if cond_codes.numel():
            vmax = int(cond_codes.max())
            if vmax >= self.transformer.vocab_cond_size:
                raise ValueError(
                    f"condition id {vmax} >= vocab_cond_size="
                    f"{self.transformer.vocab_cond_size}; check the "
                    "dataset's class range vs the transformer config")
        return cond_codes.to(torch.int32)

    def shared_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.loss_fn(*self.encode_inputs(batch))

    # -- sampling -------------------------------------------------------------

    def sample(self, conds, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               softmax_temperature: float = 1.0, seed: int = 0,
               return_codes: bool = False, mesh=None):
        """Images (B, H, W, C) in [0, 1] for the condition codes ``conds``;
        with ``return_codes`` also the int32 codes: (B, T) from a GPT
        prior, (B, T, D) from an RQ prior, reshaped to ``code_shape``
        where the config gives one."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: data-parallel sampling over several cards is a "
                "later slice of the port (ROADMAP A9)")
        conds = self._ids(conds)
        conds = conds.reshape(conds.shape[0], -1)
        generator = torch.Generator(self.device).manual_seed(seed)
        sampler = sample_rq if self.is_rq else sample_gpt
        _, codes = sampler(self.transformer, conds, generator, top_k=top_k,
                           top_p=top_p,
                           temperature=float(softmax_temperature),
                           with_logits=False)
        if self.code_shape is not None:
            codes = codes.reshape(codes.shape[0], *self.code_shape)
        pixels = torch.clamp(self.stage1_model.decode_codes(codes), 0.0, 1.0)
        if return_codes:
            return pixels, codes
        return pixels

    def get_input(self, batch: Dict[str, Any], key: str) -> torch.Tensor:
        x = batch[key]
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        return x

    def log_images(self, batch: Dict[str, Any], **kwargs
                   ) -> Dict[str, Any]:
        conds = self.get_input(batch, self.cond_key)
        cond_codes = self.cond_model.encode_codes(conds)
        log = {}
        if hasattr(self.cond_model, "to_img"):
            log["conditions"] = self.cond_model.to_img(conds)
        log["first samples"] = self.sample(cond_codes, seed=0,
                                           top_k=kwargs.get("top_k"))
        log["second samples"] = self.sample(cond_codes, seed=1,
                                            top_k=kwargs.get("top_k"))
        return log
