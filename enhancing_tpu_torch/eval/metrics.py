"""Reconstruction and generation metrics: PSNR, SSIM, Fréchet distance,
codebook usage.

Counterpart of ``enhancing_tpu/eval/metrics.py``:

- :func:`psnr` / :func:`ssim`: per-image pixel metrics on NHWC batches
  (SSIM with the 11x11 Gaussian window, sigma 1.5, as a depthwise
  ``F.conv2d`` on the batch moved to NCHW);
- :class:`FrechetDistance`: streaming fp64 feature statistics and the
  Fréchet distance (``scipy.linalg.sqrtm``), over a pluggable feature
  function: InceptionV3 pool3 (:mod:`.inception`) for true FID, or
  :func:`vgg_feature_fn`, the LPIPS VGG16 trunk;
- :func:`codebook_usage`: the share of the codebook used and the
  perplexity of the code histogram.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Per-image PSNR over NHWC batches."""
    mse = torch.mean(torch.square(x - y), dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Mean SSIM per image (Gaussian 11x11 window, standard constants)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    c = x.shape[-1]
    w = torch.as_tensor(gaussian_kernel(), device=x.device, dtype=x.dtype)
    w = w[None, None].expand(c, 1, 11, 11)

    def filt(t):
        return F.conv2d(t.permute(0, 3, 1, 2), w, groups=c)

    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = filt(x * x) - mu_x2
    sig_y = filt(y * y) - mu_y2
    sig_xy = filt(x * y) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return torch.mean(s, dim=(1, 2, 3))


class FrechetDistance:
    """Streaming Fréchet distance between two feature distributions.

    Usage:
        fd = FrechetDistance(feature_fn)
        for batch in reals: fd.update_real(batch)
        for batch in fakes: fd.update_fake(batch)
        value = fd.compute()
    """

    def __init__(self, feature_fn: Callable[[torch.Tensor], torch.Tensor]
                 ) -> None:
        self.feature_fn = feature_fn
        self._stats = {"real": None, "fake": None}

    def _update(self, which: str, images) -> None:
        feats = self.feature_fn(images)
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().double().cpu().numpy()
        feats = np.asarray(feats, np.float64)
        feats = feats.reshape(feats.shape[0], -1)
        st = self._stats[which]
        if st is None:
            st = {"n": 0, "sum": np.zeros(feats.shape[1]),
                  "outer": np.zeros((feats.shape[1], feats.shape[1]))}
        st["n"] += feats.shape[0]
        st["sum"] += feats.sum(0)
        st["outer"] += feats.T @ feats
        self._stats[which] = st

    def update_real(self, images) -> None:
        self._update("real", images)

    def update_fake(self, images) -> None:
        self._update("fake", images)

    @staticmethod
    def _mean_cov(st) -> Tuple[np.ndarray, np.ndarray]:
        n = st["n"]
        mu = st["sum"] / n
        cov = st["outer"] / n - np.outer(mu, mu)
        return mu, cov

    def compute(self) -> float:
        import scipy.linalg
        assert self._stats["real"] and self._stats["fake"], \
            "call update_real/update_fake first"
        mu1, c1 = self._mean_cov(self._stats["real"])
        mu2, c2 = self._mean_cov(self._stats["fake"])
        diff = mu1 - mu2
        # the JAX package passes disp=False, which newer scipy (the card
        # machine's 1.18) no longer takes; the square root is the same
        covmean = np.real(scipy.linalg.sqrtm(c1 @ c2))
        return float(diff @ diff + np.trace(c1 + c2 - 2 * covmean))


def vgg_feature_fn(lpips, stage: int = 3
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Spatially pooled VGG16 stage features for a VGG-Fréchet distance:
    ``lpips`` is a ``losses.lpips.LPIPS`` (its trunk is ``lpips.net``) or
    the ``VGG16Features`` trunk itself. Images are NHWC in [0, 1]."""
    net = getattr(lpips, "net", lpips)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        feats = net(images.float() * 2 - 1)
        return torch.mean(feats[stage], dim=(1, 2))
    return fn


def codebook_usage(codes, n_embed: int) -> dict:
    """Share of the codebook used and the perplexity of the empirical code
    histogram."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().cpu().numpy()
    hist = np.bincount(np.asarray(codes).reshape(-1), minlength=n_embed)
    p = hist / max(hist.sum(), 1)
    nz = p[p > 0]
    perplexity = float(np.exp(-(nz * np.log(nz)).sum()))
    return {"usage": float((hist > 0).mean()), "perplexity": perplexity,
            "n_used": int((hist > 0).sum())}
