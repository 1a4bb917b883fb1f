"""In-place row writes into the stacked KV cache of the decode loop.

Counterpart of ``enhancing_tpu/ops/cache.py::cache_row_update``: after the
last layer of a decode step, the new token's key (or value) rows of every
layer, ``news`` (L, B, 1, C), go to position ``cur[b]`` of each batch row
of the (L, B, ctx, C) stack, in place. On CUDA the kernel
``csrc/cache_row_update.cu`` copies just those rows; the plain version is
an indexed assignment. The JAX package writes through a Pallas kernel to
pin the cache's layout inside XLA's loop (``ops/cache.py:3-17`` there);
PyTorch has no such layout to pin, and the port keeps the kernel as the
one in-place write of the step.

Positions outside [0, ctx), on both routes: a scalar raises on the host;
a row of a (B,) vector is left unwritten, as the JAX package's ragged path
(a masked select over ctx) leaves it. A per-row check would cost a
device-to-host wait at every decode step.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, row_positions, use_kernel


def _check_scalar(cur_len, ctx: int) -> None:
    if isinstance(cur_len, int) and not 0 <= cur_len < ctx:
        raise IndexError(f"position {cur_len} outside a cache of {ctx}")


def cache_row_update_plain(cache: torch.Tensor, news: torch.Tensor,
                           cur_len) -> torch.Tensor:
    """``cache[l, b, cur[b]] = news[l, b, 0]`` by indexed assignment, rows
    with a position outside [0, ctx) skipped. ``cache`` may also be the
    (L, B, ctx) row scales of an int8 cache, ``news`` (L, B, 1)."""
    rows = news[:, :, 0].to(cache.dtype)
    b, ctx = cache.shape[1], cache.shape[2]
    _check_scalar(cur_len, ctx)
    if isinstance(cur_len, int):
        cache[:, :, cur_len] = rows
    else:
        cur = row_positions(cur_len, b, cache.device).long()
        hit = (cur >= 0) & (cur < ctx)
        batch_rows = torch.arange(b, device=cache.device)
        cache[:, batch_rows[hit], cur[hit]] = rows[:, hit]
    return cache


def cache_row_update_kernel(cache: torch.Tensor, news: torch.Tensor,
                            cur_len) -> torch.Tensor:
    """Launch ``csrc/cache_row_update.cu`` on a CUDA cache of any dtype."""
    l, b, ctx, c = cache.shape
    if news.shape != (l, b, 1, c) or news.dtype != cache.dtype:
        raise ValueError(f"news {tuple(news.shape)} {news.dtype} does not "
                         f"fit a cache {tuple(cache.shape)} {cache.dtype}")
    row_bytes = c * cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"cache rows of {row_bytes} bytes: the kernel "
                         "copies 16-byte vectors")
    _check_scalar(cur_len, ctx)
    if isinstance(cur_len, int):
        cur_vec, cur_ptr = None, None
    else:
        cur_vec = row_positions(cur_len, b, cache.device)
        cur_ptr = cur_vec.data_ptr()
    check_kernel_args("cache_row_update", cache, news, cur_vec)
    cuda_lib.call("etk_cache_row_update", cache.data_ptr(), news.data_ptr(),
                  cur_ptr, cur_len if cur_vec is None else 0, l, b, ctx,
                  row_bytes, cuda_lib.stream())
    LAUNCHES["cache_row_update"] += 1
    return cache


def cache_row_update(cache: torch.Tensor, news: torch.Tensor,
                     cur_len) -> torch.Tensor:
    """Write one row per (layer, batch row) into the stacked cache, in place.

    cache: (L, B, ctx, C); news: (L, B, 1, C), cast to the cache's dtype;
    cur_len: a Python int (the lockstep sampler) in [0, ctx), or a (B,)
    tensor of per-row positions (ragged batches; a row outside [0, ctx) is
    not written). Returns ``cache`` itself.
    """
    if use_kernel(cache, news, op="cache_row_update"):
        return cache_row_update_kernel(cache, news.to(cache.dtype), cur_len)
    return cache_row_update_plain(cache, news, cur_len)


def scale_row_update(scales: torch.Tensor, news: torch.Tensor,
                     cur_len) -> torch.Tensor:
    """Write one position of the (L, B, ctx) fp32 row scales of an int8 KV
    cache, in place: ``news`` (L, B, 1) at ``cur_len`` (an int, or a (B,)
    tensor whose rows outside [0, ctx) are not written). Plain indexing on
    both devices, as the JAX package keeps it plain XLA
    (``enhancing_tpu/ops/cache.py:107-121``): a few bytes a row next to the
    cache rows it describes. Returns ``scales``."""
    return cache_row_update_plain(scales, news, cur_len)
