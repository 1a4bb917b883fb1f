"""Self-attention straight off the fused qkv projection output.

Counterpart of ``multihead_attention_packed_qkv`` in
``enhancing_tpu/ops/attention.py``. On CUDA the Hopper flash forward
``attn_fwd_kernel`` of ``csrc/attention_bnhd.cu`` (entry
``etk_attention_qkv``) reads q, k and v in place from the (B, N, 3*H*D)
buffer through 4-D TMA tensor maps (:func:`attention_fwd_maps` mirrors
them); the plain version splits it, as ``_qkv_split_scaled`` and
``_attention_xla`` do (``attention.py:42-57,701-704``). Numerics: q is
scaled in the compute dtype, scores and softmax are fp32, P is cast to
v's dtype before PV, and the output is cast to the compute dtype.

On CUDA the entry point is a ``torch.autograd.Function``, as
``_attention_fused_packed_qkv`` is a ``custom_vjp`` there
(``attention.py:724-746``): the forward saves qkv; the backward splits q
(scaled), k and v, runs the flash backward ``csrc/attention_bwd.cu`` on
them and dO, chains dq through the scale and concatenates
``[dq | dk | dv]``. The backward's plain version is autograd of the plain
forward.

More entry points serve the stage-2 GPT prior and the JAX package's
other attention forwards:

- :func:`multihead_attention_bnhd`, the counterpart of the JAX function of
  that name (``attention.py:1810-1855``), takes separate (B, N, H, D) q, k
  and v; on CUDA ``csrc/attention_bnhd.cu`` (the counterpart of
  ``_attention_packed_call``, B8) reads them in place at any N, N = 1
  included: head dims up to 128 on ``attn_fwd_kernel``, B2's kernel,
  so that B8 on the lane slices of a qkv buffer gives B2's output bit for
  bit; the prior's 384 on ``attn_wide_kernel`` (an S warpgroup hands P to
  three O warpgroups that own 128 lanes of O each). Same numerics as
  above. It has no backward yet: the prior's training step is a later
  slice. Both kernels read each tensor through its own batch, head and row
  strides (4-D TMA maps, :func:`attention_fwd_maps`) and a key length of
  its own, and put the scale on q (in bf16) or on the fp32 scores, so they
  also serve
  :func:`multihead_attention` ((B, H, N, D), the scale on the scores, the
  JAX public op; backward autograd of the plain version),
  :func:`_attention_fused_bnhd` ((B, N, H, D), likewise) and
  :func:`attention_packed_gridchunk` (prefix-causal on pre-scaled packed
  q, k, v).
- :func:`attention_proj_packed`, attention -> output projection -> bias
  -> residual in one kernel, ``csrc/attn_proj.cu``, on the lane slices of
  the qkv buffer (the ViT's opt-in ``ENHANCING_TPU_ATTN_PROJ`` path);
  under autograd the unfused B8 + projection, backward B5.
- :func:`decode_attention` and :func:`decode_attention_stacked`, one
  token's attention against the rows < cur_len of a KV cache plus the
  token's own key and value (``attention.py:1722-1807``); on CUDA
  ``csrc/decode_attention.cu`` (the counterpart of ``_decode_pallas``),
  one launch of a cluster kernel whose plan :func:`decode_plan` mirrors,
  selects the layer of a stacked cache inside the kernel. The plain
  version is ``_decode_xla`` (``attention.py:1314-1338``) on the layer's
  slice; both clamp a per-row cur_len to [0, ctx], as its mask does. q may
  be fp32 under a bf16 cache (the int8-weight decode step). An int8 cache
  comes with per-row fp32 ``k_scale``/``v_scale`` (L, B, ctx); the plain
  version dequantises the layer to q's dtype first (``_dequant_cache``,
  ``attention.py:1604-1608``), the kernel scales the score columns by the
  keys' scales and the softmax weights by the values', as
  ``_decode_kernel`` does.

Every attention entry takes bf16 and fp32 (:func:`attention_route`): the
Hopper kernels above run bf16, a head dim that is a multiple of 8 up to
128 on the next of their tiles of 32, 64 and 128 lanes (zeros past it
through the tensor maps); fp32 runs ``csrc/attention_f32.cu``, forward
(B2, B8 up to 128 and at 384, B17-B19) and backward (B5), fp32 sums
throughout and no TF32, counted under the bf16 kernel's name and in
``F32_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from . import cuda_lib
from .common import (F32_LAUNCHES, LAUNCHES, check_kernel_args,
                     row_positions, use_kernel)
from .ln_gemm import _plain_vjp

NEG_INF = -1e30
MASK_MODES = {"none": 0, "prefix_causal": 1}
# The head dims of the attention kernels. bf16: attn_fwd_kernel
# (csrc/attention_bnhd.cu) and csrc/attention_bwd.cu run a head dim that is
# a multiple of 8 up to 128 on the next of their tiles of 32, 64 and 128
# lanes (the lanes past it are zeros that their 4-D tensor maps load and
# their stores drop), attn_wide_kernel the prior's 384 (forward only).
# fp32: csrc/attention_f32.cu, tiles of 32, 64, 96 and 128 lanes up to 128,
# and 384 (forward only).
KERNEL_TILES = (32, 64, 128)
F32_TILES = (32, 64, 96, 128)
WIDE_HEAD_DIM = 384


def attention_route(dtype: torch.dtype, head_dim: int,
                    backward: bool = False) -> tuple:
    """(kernel, tile) that the attention entries launch for ``dtype`` and
    ``head_dim``, as the C entries choose them: bf16 forwards on
    ``attn_fwd_kernel`` (tile 32, 64 or 128) or ``attn_wide_kernel`` (384),
    the bf16 backward on ``attn_bwd`` (``csrc/attention_bwd.cu``), fp32 on
    ``attn_f32_fwd_kernel`` / ``attn_f32_bwd`` (``csrc/attention_f32.cu``).
    Raises TypeError for another dtype and ValueError for a head dim no
    kernel takes: not a multiple of 8, above 128 but not 384, or 384 in
    the backward (ROADMAP.md queue B)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernels take bf16 or fp32, got {dtype}")
    tiles = KERNEL_TILES if dtype == torch.bfloat16 else F32_TILES
    if head_dim == WIDE_HEAD_DIM and not backward:
        return ("attn_wide_kernel" if dtype == torch.bfloat16
                else "attn_f32_fwd_kernel", WIDE_HEAD_DIM)
    if head_dim <= 0 or head_dim % 8 or head_dim > tiles[-1]:
        raise ValueError(
            f"attention {'backward ' if backward else ''}kernel takes a "
            f"head_dim that is a multiple of 8 up to {tiles[-1]}"
            + ("" if backward else f" or {WIDE_HEAD_DIM}")
            + f", got {head_dim}")
    tile = next(t for t in tiles if head_dim <= t)
    if dtype == torch.bfloat16:
        return ("attn_bwd" if backward else "attn_fwd_kernel", tile)
    return ("attn_f32_bwd" if backward else "attn_f32_fwd_kernel", tile)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (q dtype, cache dtype) pairs of csrc/decode_attention.cu
DECODE_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32,
                                                   torch.float32),
                (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
                (torch.bfloat16, torch.int8)}


def bf16_round(x: float) -> float:
    """``x`` rounded to the nearest bf16 (ties to even), as
    ``float(torch.tensor(x, dtype=torch.bfloat16))`` gives it for a finite
    x, without a tensor on the launch path."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, mask_mode: str = "none",
                    cond_len: int = 0) -> torch.Tensor:
    """q, k, v: (B, H, N, D). Softmax in fp32, output in q.dtype."""
    n, m = q.shape[-2], k.shape[-2]
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if mask_mode == "prefix_causal":
        rows = torch.arange(n, device=q.device)[:, None]
        cols = torch.arange(m, device=q.device)[None, :]
        allowed = (cols <= rows) | ((rows < cond_len) & (cols < cond_len))
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    elif mask_mode != "none":
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def split_qkv_scaled(qkv: torch.Tensor, scale: float):
    """[q | k | v] lanes of (B, N, 3*H*D), with q scaled in qkv's dtype."""
    hd = qkv.shape[-1] // 3
    q = qkv[..., :hd] * torch.tensor(scale, dtype=qkv.dtype)
    return q, qkv[..., hd:2 * hd], qkv[..., 2 * hd:]


def attention_packed_qkv_plain(qkv, heads, head_dim, scale,
                               mask_mode="none", cond_len=0):
    """Plain version of the packed-qkv kernel: (B, N, 3*H*D) -> (B, N, H*D)."""
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, heads, head_dim).transpose(1, 2)
               for t in split_qkv_scaled(qkv, scale))
    out = attention_plain(q, k, v, 1.0, mask_mode, cond_len)
    return out.transpose(1, 2).reshape(b, n, heads * head_dim)


def attention_packed_qkv_kernel(qkv, heads, head_dim, scale,
                                mask_mode="none", cond_len=0):
    """Launch ``attn_fwd_kernel`` (``csrc/attention_bnhd.cu``, entry
    ``etk_attention_qkv``) on a CUDA bf16 (B, N, 3*H*D) tensor (B2), or
    ``attn_f32_fwd_kernel`` (``csrc/attention_f32.cu``) on an fp32 one;
    head dims that are multiples of 8 up to 128."""
    b, n, hd3 = qkv.shape
    if attention_route(qkv.dtype, head_dim)[1] == WIDE_HEAD_DIM:
        raise ValueError(f"attention kernel takes a head_dim up to 128 on "
                         f"the qkv buffer, got {head_dim}")
    if hd3 != 3 * heads * head_dim:
        raise ValueError(f"qkv last dim {hd3} != 3 * {heads} * {head_dim}")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    check_kernel_args("attention", qkv)
    out = torch.empty((b, n, heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    if qkv.dtype == torch.float32:
        views = [t.view(b, n, heads, head_dim)
                 for t in (*qkv.split(heads * head_dim, dim=-1), out)]
        return attention_f32_launch("attention", *views, scale, False,
                                    mask_mode, cond_len).view(out.shape)
    # the TPU kernel scales the bf16 q tile by the scale rounded to bf16
    scale_c = bf16_round(float(scale))
    cuda_lib.call("etk_attention_qkv", qkv.data_ptr(), out.data_ptr(), b, n,
                  heads, head_dim, scale_c, MASK_MODES[mask_mode],
                  int(cond_len), cuda_lib.stream())
    LAUNCHES["attention"] += 1
    return out


def attention_bwd_plain(q3, k3, v3, do3, heads, head_dim, mask_mode="none",
                        cond_len=0):
    """Plain version of the backward kernel: autograd of the attention on
    (B, N, H*D) q (already scaled), k and v against dO."""
    b, n, _ = q3.shape
    leaves = [t.detach().requires_grad_() for t in (q3, k3, v3)]
    with torch.enable_grad():
        q, k, v = (t.reshape(b, n, heads, head_dim).transpose(1, 2)
                   for t in leaves)
        out = attention_plain(q, k, v, 1.0, mask_mode, cond_len)
        out = out.transpose(1, 2).reshape(b, n, heads * head_dim)
        return torch.autograd.grad(out, leaves, do3)


def attention_bwd_kernel(q3, k3, v3, do3, heads, head_dim, mask_mode="none",
                         cond_len=0):
    """Launch ``csrc/attention_bwd.cu`` on CUDA bf16 (B, N, H*D) q (already
    scaled), k, v and dO, or ``csrc/attention_f32.cu``'s backward on fp32
    ones, each contiguous or a lane slice of a wider buffer with 16-byte
    aligned rows; head dims that are multiples of 8 up to 128. Returns
    contiguous dq, dk and dv."""
    b, n, hd = q3.shape
    if any(t.dtype != q3.dtype for t in (k3, v3, do3)):
        raise TypeError("attention backward kernel takes q, k, v, dO of one "
                        "dtype")
    attention_route(q3.dtype, head_dim, backward=True)
    if hd != heads * head_dim:
        raise ValueError(f"attention backward kernel takes H*D lanes, got "
                         f"{tuple(q3.shape)} for {heads} x {head_dim}")
    if any(t.shape != q3.shape for t in (k3, v3, do3)):
        raise ValueError("attention backward: q, k, v and dO shapes differ")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    check_kernel_args("attention_bwd", q3, k3, v3, do3, strided_rows=True)
    grads = [torch.empty((b, n, hd), dtype=q3.dtype, device=q3.device)
             for _ in range(3)]
    # the row statistics of every 128-row block of the rows kernel
    n_pad = -(-n // 128) * 128
    stats = torch.empty((3, b, heads, n_pad), dtype=torch.float32,
                        device=q3.device)
    f32 = q3.dtype == torch.float32
    cuda_lib.call("etk_attention_bwd_f32" if f32 else "etk_attention_bwd",
                  *(t.data_ptr() for t in (q3, k3, v3, do3, *grads, stats)),
                  *(t.stride(1) for t in (q3, k3, v3, do3, *grads)),
                  b, n, heads, head_dim, MASK_MODES[mask_mode],
                  int(cond_len), cuda_lib.stream())
    LAUNCHES["attention_bwd"] += 1
    if f32:
        F32_LAUNCHES["attention_bwd"] += 1
    return tuple(grads)


class _PackedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, head_dim, scale, mask_mode, cond_len):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, head_dim, scale, mask_mode, cond_len)
        return attention_packed_qkv_kernel(qkv, heads, head_dim, scale,
                                           mask_mode, cond_len)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        heads, head_dim, scale, mask_mode, cond_len = ctx.args
        q3, k3, v3 = split_qkv_scaled(qkv, scale)
        dq, dk, dv = attention_bwd_kernel(q3, k3, v3,
                                          g.to(qkv.dtype).contiguous(), heads,
                                          head_dim, mask_mode, cond_len)
        dq = dq * torch.tensor(scale, dtype=dq.dtype)  # through q's scale
        return torch.cat([dq, dk, dv], dim=-1), None, None, None, None, None


def multihead_attention_packed_qkv(qkv: torch.Tensor, heads: int,
                                   head_dim: int, *,
                                   scale: float | None = None,
                                   mask_mode: str = "none",
                                   cond_len: int = 0) -> torch.Tensor:
    """Self-attention of the fused qkv projection output.

    qkv: (B, N, 3*heads*head_dim), laid out [q | k | v] along the last
    axis. Returns (B, N, heads*head_dim). mask_mode is 'none'
    (bidirectional, the ViT) or 'prefix_causal' (causal, with the first
    ``cond_len`` tokens mutually visible).
    """
    if scale is None:
        scale = head_dim ** -0.5
    if qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not hold 3 x {heads} "
                         f"heads of {head_dim}")
    if use_kernel(qkv, op="attention"):
        return _PackedQKVAttention.apply(qkv.contiguous(), heads, head_dim,
                                         scale, mask_mode, cond_len)
    return attention_packed_qkv_plain(qkv, heads, head_dim, scale, mask_mode,
                                      cond_len)


def attention_bnhd_plain(q, k, v, scale, mask_mode="none", cond_len=0):
    """Plain version of the separate-q/k/v kernel on (B, N, H, D) tensors:
    q scaled in its dtype, then :func:`attention_plain`."""
    q = q * torch.tensor(scale, dtype=q.dtype)
    out = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), 1.0, mask_mode, cond_len)
    return out.transpose(1, 2)


def strided_launch_args(name: str, tensors) -> list:
    """The (batch, head, row) element strides of (B, N, H, D) views, 0 for
    an axis of size 1 (never stepped), after the checks of the
    stride-addressed attention kernels: each last axis contiguous, every
    stride a multiple of 8 elements that fits an int, the data 16-byte
    aligned (the kernel loads 16-byte vectors); one device; no autograd
    graph, as ``check_kernel_args``."""
    strides, device = [], tensors[0].device
    grad = torch.is_grad_enabled()
    for t in tensors:
        st, sh = t.stride(), t.shape
        s = (st[0] if sh[0] > 1 else 0, st[2] if sh[2] > 1 else 0,
             st[1] if sh[1] > 1 else 0)
        if (st[3] != 1 or any(x % 8 or x >= 2 ** 31 for x in s)
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: kernel inputs need a contiguous last "
                             "axis, strides that are multiples of 8 and "
                             "16-byte aligned data")
        if t.device != device:
            raise ValueError(f"{name}: inputs on {device} and {t.device}")
        if grad and t.requires_grad:
            raise NotImplementedError(
                f"{name}: a raw kernel launch records no gradient; call the "
                "op's differentiable entry point or detach the inputs")
        strides += s
    return strides


# csrc/attention_bnhd.cu's Hopper forwards (attn_fwd_kernel on tiles of 32,
# 64 and 128 lanes, attn_wide_kernel at 384): the rows of one TMA box (one
# warpgroup's) and the grid's limits on heads and batches
FWD_BOX_ROWS, FWD_GRID_LIMIT = 64, 65535


def attention_fwd_maps(b: int, n: int, m: int, heads: int, head_dim: int,
                       strides, offsets=(0, 0, 0, 0)) -> list:
    """The four TMA tensor maps (q, k, v, out) that the host plan of
    ``csrc/attention_bnhd.cu`` encodes for ``attn_fwd_kernel`` and
    ``attn_wide_kernel``, each as
    (base offset in bytes, dims, strides in bytes, box): dims and box in the
    map's order (lanes, heads, rows, batches), strides those of heads, rows
    and batches (``sm90::tensor_map_4d``). ``strides`` holds each tensor's
    (batch, head, row) element strides, as :func:`strided_launch_args` gives
    them; ``offsets`` each base's bytes from the pointer the caller holds
    (the packed qkv buffer's lane slices, :func:`packed_qkv_strides`). An
    axis of extent 1 is never stepped and takes the stride of ``head_dim``
    elements, whatever it was given. The lane extent is the head dim, also
    where the kernel's tile (``fwd_tile`` of the C source, mirrored by
    :func:`attention_route`) is wider: its boxes load zeros past it and
    its stores drop those lanes. Raises ValueError where the C entries
    return ETK_BAD_ARGS: a head dim :func:`attention_route` refuses, an
    empty or too large grid, a stride that is negative, no multiple of 8
    elements, past an int, or 0 on an axis of extent above 1."""
    tile = attention_route(torch.bfloat16, head_dim)[1]
    check_grid("attention forward", b, n, m, heads)
    box = (32 if tile == 32 else 64, 1, FWD_BOX_ROWS, 1)
    maps = []
    for i, rows in enumerate((n, m, m, n)):
        batch, head, row = strides[3 * i:3 * i + 3]
        byte_strides = []
        for extent, st in ((heads, head), (rows, row), (b, batch)):
            if st < 0 or st % 8 or st >= 2 ** 31 or (st == 0 and extent > 1):
                raise ValueError(f"attention forward: stride {st} on an axis "
                                 f"of {extent} (multiples of 8 elements, 0 "
                                 "only on an axis of 1)")
            byte_strides.append(2 * (head_dim if extent == 1 else st))
        maps.append((offsets[i], (head_dim, heads, rows, b),
                     tuple(byte_strides), box))
    return maps


def packed_qkv_strides(b: int, n: int, heads: int, head_dim: int):
    """The element strides and byte offsets that ``etk_attention_qkv``
    gives :func:`attention_fwd_maps`' C twin for a (B, N, 3*H*D) qkv buffer
    and a contiguous (B, N, H*D) out: q, k and v its lane slices at H*D
    element steps (head stride D, row stride 3*H*D, batch N*3*H*D)."""
    hd = heads * head_dim
    strides = [n * 3 * hd, head_dim, 3 * hd] * 3 + [n * hd, head_dim, hd]
    return strides, (0, 2 * hd, 4 * hd, 0)


def check_grid(name: str, b: int, n: int, m: int, heads: int) -> None:
    """Refuse, as the C entries do, a grid the forwards cannot launch."""
    if min(b, n, m, heads) <= 0 or max(b, heads) > FWD_GRID_LIMIT:
        raise ValueError(f"{name}: B={b}, N={n}, M={m}, H={heads} is not a "
                         "grid it takes")


def attention_f32_launch(name, q, k, v, o, scale, score_scale, mask_mode,
                         cond_len):
    """Launch ``attn_f32_fwd_kernel`` (``csrc/attention_f32.cu``, entry
    ``etk_attention_f32``) on fp32 (B, N, H, D) q and out and (B, M, H, D)
    k, v, each read or written in place through its strides (the checks of
    :func:`strided_launch_args`). The scale multiplies q in fp32, or the
    fp32 scores with ``score_scale``. Counts the launch under ``name``, in
    ``LAUNCHES`` with the bf16 launches and in ``F32_LAUNCHES``; returns
    o."""
    b, n, h, d = q.shape
    attention_route(torch.float32, d)
    check_grid(f"{name} kernel", b, n, k.shape[1], h)
    strides = strided_launch_args(name, (q, k, v, o))
    cuda_lib.call("etk_attention_f32", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), (ctypes.c_int * 12)(*strides),
                  b, n, k.shape[1], h, d, float(scale), int(score_scale),
                  MASK_MODES[mask_mode], int(cond_len), cuda_lib.stream())
    LAUNCHES[name] += 1
    F32_LAUNCHES[name] += 1
    return o


def attention_strided_kernel(name, q, k, v, scale, mask_mode="none",
                             cond_len=0, *, layout="bnhd",
                             score_scale=False):
    """Launch ``csrc/attention_bnhd.cu`` on CUDA bf16 q (B, N, H, D) and k,
    v (B, M, H, D), or with ``layout="bhnd"`` (B, H, N, D) and (B, H, M,
    D), each read in place through its strides by the tensor maps of
    :func:`attention_fwd_maps`: at head dims up to 128 the Hopper forward
    ``attn_fwd_kernel`` (B2's kernel), at 384 ``attn_wide_kernel``; or on
    fp32 ones ``csrc/attention_f32.cu`` (:func:`attention_f32_launch`).
    ``score_scale`` puts the scale on the fp32 scores (B17, B18), else q
    is scaled in its dtype (B8, B19). Returns a contiguous tensor of q's
    layout; counts the launch under ``name``."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes q, k, v of one dtype")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name} kernel takes 4-d q, k, v")
    if layout == "bhnd":
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b, n, h, d = q.shape
    m = k.shape[1]
    attention_route(q.dtype, d)
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    if layout == "bhnd":
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
        o = out.transpose(1, 2)
    else:
        out = o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        attention_f32_launch(name, q, k, v, o, scale, score_scale, mask_mode,
                             cond_len)
        return out
    strides = strided_launch_args(name, (q, k, v, o))
    attention_fwd_maps(b, n, m, h, d, strides)  # refuses as the C entry
    # the TPU wrappers scale q by the scale rounded to q's dtype (B8, B19);
    # B17 and B18 multiply the fp32 scores by the scale
    scale_c = float(scale) if score_scale else bf16_round(float(scale))
    cuda_lib.call("etk_attention_bnhd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), (ctypes.c_int * 12)(*strides),
                  b, n, m, h, d, scale_c, int(score_scale),
                  MASK_MODES[mask_mode], int(cond_len), cuda_lib.stream())
    LAUNCHES[name] += 1
    return out


def attention_bnhd_kernel(q, k, v, scale, mask_mode="none", cond_len=0):
    """Launch ``csrc/attention_bnhd.cu`` (B8) on CUDA bf16 (B, N, H, D) q
    and (B, M, H, D) k, v, each a strided view (lane slices of a wider
    buffer included): ``attn_fwd_kernel`` at D <= 128, ``attn_wide_kernel``
    at 384. Returns a contiguous (B, N, H, D)."""
    return attention_strided_kernel("attention_bnhd", q, k, v, scale,
                                    mask_mode, cond_len)


def multihead_attention_bnhd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float | None = None,
                             mask_mode: str = "none",
                             cond_len: int = 0) -> torch.Tensor:
    """Attention over (batch, seq, heads, head_dim) q, k and v; returns the
    same layout. mask_mode 'none' or 'prefix_causal' (causal, the first
    ``cond_len`` tokens mutually visible); scale defaults to D**-0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_kernel(q, k, v, op="attention_bnhd"):
        return attention_bnhd_kernel(q, k, v, scale, mask_mode, cond_len)
    return attention_bnhd_plain(q, k, v, scale, mask_mode, cond_len)


def _check_decode_len(cur_len, m: int) -> None:
    """A scalar cur_len outside [0, M] raises on the host; a row of a (B,)
    vector is clamped to [0, M], as ``_decode_xla``'s mask reads it, on
    both routes (a per-row check would wait on the device every step)."""
    if isinstance(cur_len, int) and not 0 <= cur_len <= m:
        raise ValueError(f"cur_len {cur_len} outside a cache of {m}")


def decode_attention_plain(q3, kc, vc, kn, vn, cur_len, head_dim):
    """``_decode_xla``: q3 (pre-scaled), kn, vn (B, H*D); kc, vc (B, M, H*D)
    with rows < cur_len valid; cur_len an int or a (B,) tensor. Scores and
    softmax in fp32, the weights cast to the cache's dtype for PV."""
    b, m, hd = kc.shape
    _check_decode_len(cur_len, m)
    h = hd // head_dim
    qh = q3.reshape(b, h, 1, head_dim).float()
    kh = kc.reshape(b, m, h, head_dim).transpose(1, 2).float()
    vh = vc.reshape(b, m, h, head_dim).transpose(1, 2)
    knh = kn.reshape(b, h, 1, head_dim).float()
    vnh = vn.reshape(b, h, 1, head_dim)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    pos = torch.arange(m, device=kc.device)
    bound = (cur_len if isinstance(cur_len, int)
             else row_positions(cur_len, b, kc.device)[:, None, None, None])
    s = torch.where(pos < bound, s, torch.full_like(s, NEG_INF))
    s_self = (qh * knh).sum(-1, keepdim=True)
    mx = torch.maximum(s.amax(-1, keepdim=True), s_self)
    e = torch.exp(s - mx)
    e_self = torch.exp(s_self - mx)
    denom = e.sum(-1, keepdim=True) + e_self
    y = torch.einsum("bhqk,bhkd->bhqd", e.to(vh.dtype), vh)
    y = (y + e_self.to(vh.dtype) * vnh) / denom.to(vh.dtype)
    return y.transpose(1, 2).reshape(b, hd).to(q3.dtype)


def dequant_cache(kc, vc, k_scale, v_scale, dtype):
    """``_dequant_cache``: int8 rows times their fp32 scales, in ``dtype``."""
    k = kc.float() * k_scale[..., None].float()
    v = vc.float() * v_scale[..., None].float()
    return k.to(dtype), v.to(dtype)


# csrc/decode_attention.cu's plan: a (batch row, head) pair is one
# thread-block cluster of DECODE_CLUSTER blocks of DECODE_WARPS warps, and
# each warp takes one of the pair's DECODE_SPLITS contiguous splits of its
# keys through a ring of DECODE_STAGES stages of 4 / itemsize keys; head
# dims up to DECODE_MAX_HEAD_DIM (4 lanes a lane per 128)
DECODE_CLUSTER, DECODE_WARPS, DECODE_STAGES = 2, 8, 3
DECODE_SPLITS = DECODE_CLUSTER * DECODE_WARPS
DECODE_MAX_HEAD_DIM = 512


def decode_plan(head_dim: int, itemsize: int) -> dict:
    """The plan that ``etk_decode_plan`` returns for head dim D and a cache
    of ``itemsize``-byte elements: blocks a cluster, warps a block, keys a
    ring stage, ring stages and the bytes of dynamic shared memory (every
    warp's ring of K and V rows, which at the end holds the warp's partial
    O and (m, l)). Raises ValueError for a head dim the kernel does not
    take: not a multiple of 4, above 512, or head rows that are not a
    multiple of 16 bytes."""
    if itemsize not in (1, 2, 4):
        raise ValueError(f"decode_attention: cache elements of {itemsize} "
                         "bytes")
    if (head_dim <= 0 or head_dim % 4 or head_dim > DECODE_MAX_HEAD_DIM
            or (head_dim * itemsize) % 16):
        raise ValueError(f"decode_attention kernel: head_dim {head_dim} "
                         f"(a multiple of 4 up to {DECODE_MAX_HEAD_DIM}, "
                         "16-byte head rows)")
    keys = 4 // itemsize
    smem = DECODE_WARPS * DECODE_STAGES * 2 * keys * head_dim * itemsize
    return dict(cluster=DECODE_CLUSTER, warps=DECODE_WARPS,
                keys_per_stage=keys, stages=DECODE_STAGES, smem=smem)


def decode_key_splits(cur_len, ctx: int) -> list:
    """Each batch row's DECODE_SPLITS key ranges [k0, k1), as the kernel's
    warps take them: the row's length clamped to [0, ctx] (a (B,) vector;
    a scalar outside raises, :func:`_check_decode_len`), cut into
    contiguous splits of ceil(len / DECODE_SPLITS) keys, the last ones
    short or empty. One list of ranges for an int, one per row for a
    vector."""
    _check_decode_len(cur_len, ctx)

    def splits(cur):
        per = -(-cur // DECODE_SPLITS)
        out = []
        for i in range(DECODE_SPLITS):
            k0 = min(cur, i * per)
            out.append((k0, min(cur, k0 + per)))
        return out
    if isinstance(cur_len, int):
        return splits(cur_len)
    return [splits(min(max(int(c), 0), ctx)) for c in cur_len]


def decode_attention_kernel(q3, k_stack, v_stack, kn, vn, cur_len, layer,
                            head_dim, k_scale=None, v_scale=None):
    """Launch ``csrc/decode_attention.cu`` on CUDA q3, kn, vn (B, H*D) and
    a stacked (L, B, M, H*D) cache; ``layer`` is resolved inside the
    kernel. (q, cache) dtypes: (bf16, bf16), (f32, f32), (f32, bf16), and
    an int8 cache under f32 or bf16 q with fp32 (L, B, M) scales; kn, vn
    in q's dtype beside an int8 cache, else in the cache's. The output is
    in q's dtype. cur_len: int or (B,) tensor. One launch, no workspace:
    the splits of a row's keys merge inside their cluster."""
    l, b, m, hd = k_stack.shape
    qd, cd = q3.dtype, k_stack.dtype
    int8 = cd == torch.int8
    nd = qd if int8 else cd
    if (qd, cd) not in DECODE_PAIRS or v_stack.dtype != cd or any(
            t.dtype != nd for t in (kn, vn)):
        raise TypeError(f"decode_attention kernel: q {qd}, cache {cd} / "
                        f"{v_stack.dtype}, new key and value {kn.dtype} / "
                        f"{vn.dtype} is not a pair it takes")
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError("decode_attention kernel: k_scale and v_scale go "
                         "with an int8 cache, and only with it")
    if int8 and any(t.shape != (l, b, m) or t.dtype != torch.float32
                    for t in (k_scale, v_scale)):
        raise ValueError(f"decode_attention kernel: scales must be fp32 "
                         f"{(l, b, m)}")
    if v_stack.shape != k_stack.shape or any(
            t.shape != (b, hd) for t in (q3, kn, vn)):
        raise ValueError(f"decode_attention kernel: q {tuple(q3.shape)}, "
                         f"cache {tuple(k_stack.shape)}, new "
                         f"{tuple(kn.shape)} {tuple(vn.shape)} do not fit")
    if hd % head_dim:
        raise ValueError(f"decode_attention kernel: head_dim {head_dim} of "
                         f"{hd} lanes")
    decode_plan(head_dim, k_stack.element_size())  # refuses as the C entry
    if not 0 <= layer < l:
        raise IndexError(f"layer {layer} of a stack of {l}")
    heads = hd // head_dim
    _check_decode_len(cur_len, m)
    cur_vec = (None if isinstance(cur_len, int)
               else row_positions(cur_len, b, k_stack.device))
    check_kernel_args("decode_attention", q3, k_stack, v_stack, kn, vn,
                      cur_vec, k_scale, v_scale)
    out = torch.empty((b, hd), dtype=qd, device=q3.device)
    cuda_lib.call("etk_decode_attention",
                  *(t.data_ptr() for t in (q3, k_stack, v_stack, kn, vn)),
                  None if cur_vec is None else cur_vec.data_ptr(),
                  cur_len if cur_vec is None else 0, int(layer), b, m, heads,
                  head_dim, out.data_ptr(),
                  None if k_scale is None else k_scale.data_ptr(),
                  None if v_scale is None else v_scale.data_ptr(),
                  _DTYPES[qd], _DTYPES[cd], cuda_lib.stream())
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q3: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cur_len, *, head_dim: int,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """One token's attention, packed (B, H*D) layout.

    q3: the current token's query, softmax scale folded in; k_cache,
    v_cache: (B, ctx, H*D), rows < cur_len valid; k_new, v_new: (B, H*D),
    the current token's key and value (not in the cache); cur_len: an int
    or a (B,) tensor of per-row lengths; k_scale, v_scale: (B, ctx) fp32
    row scales of an int8 cache. Returns (B, H*D) in q3's dtype.
    """
    return decode_attention_stacked(
        q3, k_cache[None], v_cache[None], k_new, v_new, cur_len, 0,
        head_dim=head_dim,
        k_scale=None if k_scale is None else k_scale[None],
        v_scale=None if v_scale is None else v_scale[None])


def decode_attention_stacked(q3: torch.Tensor, k_stack: torch.Tensor,
                             v_stack: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, cur_len, layer: int, *,
                             head_dim: int, k_scale=None,
                             v_scale=None) -> torch.Tensor:
    """:func:`decode_attention` against layer ``layer`` of a stacked
    (L, B, ctx, H*D) cache (with an int8 cache, (L, B, ctx) scales); on
    CUDA the kernel selects the layer itself."""
    if use_kernel(q3, k_stack, v_stack, k_new, v_new, k_scale, v_scale,
                  op="decode_attention"):
        return decode_attention_kernel(
            q3.contiguous(), k_stack, v_stack, k_new.contiguous(),
            v_new.contiguous(), cur_len, int(layer), head_dim, k_scale,
            v_scale)
    kc, vc = k_stack[layer], v_stack[layer]
    if k_scale is not None:
        kc, vc = dequant_cache(kc, vc, k_scale[layer], v_scale[layer],
                               q3.dtype)
    return decode_attention_plain(q3, kc, vc, k_new, v_new, cur_len,
                                  head_dim)


# -- B17-B19: the other TPU attention forwards, on csrc/attention_bnhd.cu ----
# (attn_fwd_kernel at head dims 32, 64 and 128)


def attention_bhnd_kernel(q, k, v, scale, mask_mode="none", cond_len=0):
    """B17 (``_attention_pallas``) on CUDA bf16 (B, H, N, D) q and (B, H,
    M, D) k, v: the scale on the fp32 scores. Returns (B, H, N, D)."""
    return attention_strided_kernel("attention_bhnd", q, k, v, scale,
                                    mask_mode, cond_len, layout="bhnd",
                                    score_scale=True)


def attention_fused_bnhd_plain(q, k, v, scale, mask_mode="none", cond_len=0):
    """``_attention_xla_bnhd``: (B, N, H, D) q, (B, M, H, D) k, v, the scale
    on the fp32 scores."""
    out = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), scale, mask_mode, cond_len)
    return out.transpose(1, 2)


# B17 and B18 by layout: (launch counter, plain version)
SCORE_SCALE_LAYOUTS = {"bhnd": ("attention_bhnd", attention_plain),
                       "bnhd": ("attention_fused_bnhd",
                                attention_fused_bnhd_plain)}


class _ScoreScaleAttention(torch.autograd.Function):
    """B17 or B18 forward; the backward is autograd of the plain version
    recomputed from the saved inputs, as both JAX ``custom_vjp``s take the
    VJP of their XLA twin."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask_mode, cond_len, layout):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, mask_mode, cond_len)
        ctx.layout = layout
        return attention_strided_kernel(
            SCORE_SCALE_LAYOUTS[layout][0], q, k, v, scale, mask_mode,
            cond_len, layout=layout, score_scale=True)

    @staticmethod
    def backward(ctx, g):
        plain = SCORE_SCALE_LAYOUTS[ctx.layout][1]
        grads = _plain_vjp(lambda *t: plain(*t, *ctx.args),
                           zip(ctx.saved_tensors, ctx.needs_input_grad[:3]),
                           g)
        return (*grads, None, None, None, None)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None,
                        mask_mode: str = "none",
                        cond_len: int = 0) -> torch.Tensor:
    """Scaled-dot-product attention over (batch, heads, seq, head_dim) q
    and k, v of any key length: the counterpart of the JAX public
    ``multihead_attention`` (``attention.py:171-189``). The scale (default
    D**-0.5) multiplies the fp32 scores; mask_mode 'none' or
    'prefix_causal'. On CUDA the forward is ``csrc/attention_bnhd.cu``'s
    ``attn_fwd_kernel`` (B17) and the backward autograd of the plain
    version, as the JAX
    ``custom_vjp`` takes the VJP of ``_attention_xla``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_kernel(q, k, v, op="attention_bhnd"):
        return _ScoreScaleAttention.apply(q, k, v, float(scale), mask_mode,
                                          int(cond_len), "bhnd")
    return attention_plain(q, k, v, float(scale), mask_mode, int(cond_len))


def _attention_fused_bnhd(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float,
                          mask_mode: str = "none",
                          cond_len: int = 0) -> torch.Tensor:
    """The counterpart of the JAX ``_attention_fused_bnhd`` (B18,
    ``_attention_pallas_bnhd`` with the VJP of ``_attention_xla_bnhd``):
    attention over (B, N, H, D) q and (B, M, H, D) k, v in place, the
    scale on the fp32 scores. No caller in the package, as in JAX."""
    if use_kernel(q, k, v, op="attention_fused_bnhd"):
        return _ScoreScaleAttention.apply(q, k, v, float(scale), mask_mode,
                                          int(cond_len), "bnhd")
    return attention_fused_bnhd_plain(q, k, v, float(scale), mask_mode,
                                      int(cond_len))


def attention_packed_plain(q3, k3, v3, mask_mode, cond_len, head_dim):
    """``_attention_xla_packed``: packed (B, N, H*D) q (pre-scaled) and
    (B, M, H*D) k, v -> (B, N, H*D)."""
    b, n, hd = q3.shape
    m, h = k3.shape[1], hd // head_dim
    q, k, v = (t.reshape(b, -1, h, head_dim).transpose(1, 2)
               for t in (q3, k3, v3))
    out = attention_plain(q, k, v, 1.0, mask_mode, cond_len)
    return out.transpose(1, 2).reshape(b, n, hd)


def attention_packed_gridchunk(q3: torch.Tensor, k3: torch.Tensor,
                               v3: torch.Tensor, mask_mode: str,
                               cond_len: int, head_dim: int) -> torch.Tensor:
    """The counterpart of ``_attention_packed_gridchunk_call`` (B19): the
    prefix-causal forward on pre-scaled packed q (B, N, H*D) and k, v (B,
    M, H*D). The TPU kernel masks causally whatever ``mask_mode`` says, so
    only 'prefix_causal' is taken. On CUDA ``csrc/attention_bnhd.cu`` with
    a unit scale, which skips the key tiles past each warpgroup's last
    visible column (the TPU kernel's dead-chunk skip); ``block_q`` and
    ``k_chunk`` are TPU means and are not taken. Forward only, as in
    JAX."""
    if mask_mode != "prefix_causal":
        raise ValueError("the grid-chunked kernel is prefix-causal only")
    if use_kernel(q3, k3, v3, op="attention_gridchunk"):
        b, n, hd = q3.shape
        h = hd // head_dim
        if hd != h * head_dim or k3.shape[-1] != hd or v3.shape != k3.shape:
            raise ValueError(f"q {tuple(q3.shape)}, k {tuple(k3.shape)}, v "
                             f"{tuple(v3.shape)} do not hold heads of "
                             f"{head_dim}")
        q, k, v = (t.unflatten(-1, (h, head_dim)) for t in (q3, k3, v3))
        out = attention_strided_kernel("attention_gridchunk", q, k, v, 1.0,
                                       mask_mode, cond_len)
        return out.reshape(b, n, hd)
    return attention_packed_plain(q3, k3, v3, mask_mode, int(cond_len),
                                  head_dim)


# -- B15: attention -> projection -> bias -> residual ----------------------

PROJ_HEAD_DIMS = (64,)
# csrc/attn_proj.cu's shapes: 64-row blocks, 128-column projection chunks,
# a TMA ring of 16 KiB stages per consumer warpgroup beside the (64, H*D)
# bf16 tile of every head's output and four (64, 64) q tiles (two per
# warpgroup)
PROJ_ROWS, PROJ_CHUNK, PROJ_STAGE_BYTES, PROJ_MAX_STAGES = 64, 128, 16384, 4
SMEM_LIMIT = 232448 - 2048


def attn_proj_plan(heads: int, head_dim: int, ho: int) -> dict | None:
    """The kernel's plan for H heads of D and HO output columns, as
    ``csrc/attn_proj.cu::attn_proj_plan`` picks it (the C entry
    ``etk_attn_proj_plan`` returns rows, chunk, stages and smem for H*D):
    as many ring stages per warpgroup as fit beside the (64, H*D) tile and
    the q tiles, at most 4. None where the kernel refuses the shape: D
    other than 64, HO not a multiple of 64, or fewer than 2 stages (H*D
    above 1024)."""
    if head_dim not in PROJ_HEAD_DIMS or ho % 64 or heads <= 0:
        return None
    fixed = PROJ_ROWS * heads * head_dim * 2 + 4 * PROJ_ROWS * 64 * 2
    stages = min(PROJ_MAX_STAGES,
                 (SMEM_LIMIT - fixed) // (2 * PROJ_STAGE_BYTES))
    if stages < 2:
        return None
    return dict(rows=PROJ_ROWS, chunk=PROJ_CHUNK, stages=stages,
                smem=fixed + 2 * stages * PROJ_STAGE_BYTES + 1024)


def attention_proj_plain(q, k, v, wp, bp, residual, scale, mask_mode="none",
                         cond_len=0):
    """``_attention_proj_xla``: q (B, N, H, D), k, v (B, M, H, D) with q
    scaled in its dtype; the attention output in q's dtype times wp (HO,
    H*D) cast to it, fp32 products and sums, + bp and the residual in fp32,
    one rounding."""
    b, n, h, d = q.shape
    o = attention_bnhd_plain(q, k, v, scale, mask_mode, cond_len)
    out = (o.reshape(b, n, h * d).float() @ wp.to(q.dtype).float().t()
           + bp.float() + residual.float())
    return out.to(q.dtype)


def _batch_rows(t: torch.Tensor) -> torch.Tensor:
    """A (B, 1, C) view with its one row's stride set to the batches'
    (torch may give a size-1 axis any stride; the kernel steps batches by
    rows)."""
    if t.shape[1] != 1:
        return t
    return t.as_strided(t.shape, (t.stride(0), t.stride(0), t.stride(2)))


def attn_proj_kernel(q, k, v, wp, bp, residual, scale, mask_mode="none",
                     cond_len=0):
    """Launch ``csrc/attn_proj.cu`` (B15) on CUDA bf16 q (B, N, H, 64) and
    k, v (B, M, H, 64), each a view with a contiguous head axis and rows at
    a common 16-byte aligned stride (the lane slices of the qkv buffer);
    wp bf16 (HO, H*64); bp fp32 (HO,); residual bf16 (B, N, HO), all
    contiguous. Returns (B, N, HO)."""
    b, n, h, d = q.shape
    m, ho = k.shape[1], wp.shape[0]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, wp, residual)) or (
            bp.dtype != torch.float32):
        raise TypeError("attn_proj kernel takes bf16 q, k, v, wp, residual "
                        "and an fp32 bias (fp32 is not ported yet: "
                        "ROADMAP.md C1)")
    if attn_proj_plan(h, d, ho) is None:
        raise ValueError(f"attn_proj kernel takes head_dim in "
                         f"{PROJ_HEAD_DIMS}, HO % 64 == 0 and H*D up to "
                         f"1024, got H={h}, D={d}, HO={ho} (other head dims "
                         "are not ported yet: ROADMAP.md C1)")
    if (k.shape != (b, m, h, d) or v.shape != k.shape
            or wp.shape != (ho, h * d) or bp.shape != (ho,)
            or residual.shape != (b, n, ho)):
        raise ValueError("attn_proj kernel: shapes of q, k, v, wp, bp and "
                         "the residual do not fit")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    q3, k3, v3 = (_batch_rows(t.reshape(t.shape[0], t.shape[1], h * d))
                  for t in (q, k, v))
    check_kernel_args("attn_proj", q3, k3, v3, strided_rows=True)
    check_kernel_args("attn_proj", wp, bp, residual)
    out = torch.empty((b, n, ho), dtype=q.dtype, device=q.device)
    # the TPU wrapper scales q by the scale rounded to q's dtype
    scale_c = bf16_round(float(scale))
    cuda_lib.call("etk_attn_proj",
                  *(t.data_ptr() for t in (q3, k3, v3, wp, bp, residual,
                                           out)),
                  q3.stride(1), k3.stride(1), v3.stride(1), b, n, m, h, d, ho,
                  scale_c, MASK_MODES[mask_mode], int(cond_len),
                  cuda_lib.stream())
    LAUNCHES["attn_proj"] += 1
    return out


class _AttentionProj(torch.autograd.Function):
    """The training forward of ``_attention_proj_fused``'s ``custom_vjp``
    (``attention.py:1226-1262``): unfused, so the attention output is kept
    for dWp. The attention is ``csrc/attention_bnhd.cu`` (B8, B2's kernel
    and output bit for bit on the lane slices of the qkv buffer), the
    projection an fp32-accumulated product with bp and the residual added
    in fp32 and one rounding; the backward is the JAX one: dbp and dWp in
    fp32, dO rounded to the compute dtype, then ``csrc/attention_bwd.cu``
    (B5)."""

    @staticmethod
    def forward(ctx, q, k, v, wp, bp, residual, scale, mask_mode, cond_len):
        b, n, h, d = q.shape
        o3 = attention_bnhd_kernel(q, k, v, scale, mask_mode,
                                   cond_len).reshape(b, n, h * d)
        ctx.save_for_backward(q, k, v, wp, o3)
        ctx.args = (scale, mask_mode, cond_len)
        out = o3.float() @ wp.float().t() + bp.float() + residual.float()
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, wp, o3 = ctx.saved_tensors
        scale, mask_mode, cond_len = ctx.args
        b, n, h, d = q.shape
        g32 = g.float()
        dbp = g32.sum((0, 1))
        dwp = torch.einsum("bno,bni->oi", g32, o3.float())
        do = (g.to(wp.dtype).float() @ wp.float()).to(q.dtype)
        q3s = q.reshape(b, n, h * d) * torch.tensor(scale, dtype=q.dtype)
        dq, dk, dv = attention_bwd_kernel(
            q3s, k.reshape(b, n, h * d), v.reshape(b, n, h * d), do, h, d,
            mask_mode, cond_len)
        dq = dq * torch.tensor(scale, dtype=dq.dtype)  # through q's scale
        return (dq.view(q.shape), dk.view(k.shape), dv.view(v.shape),
                dwp.to(wp.dtype), dbp, g, None, None, None)


def attention_proj_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          wp: torch.Tensor, bp: torch.Tensor,
                          residual: torch.Tensor, *,
                          scale: float | None = None,
                          mask_mode: str = "none",
                          cond_len: int = 0) -> torch.Tensor:
    """residual + attention(q, k, v) (as (B, N, H*D)) @ wp^T + bp, the
    projection and residual folded into the attention kernel.

    The counterpart of the JAX ``attention_proj_packed``
    (``attention.py:1267-1300``): q (B, N, H, D), k, v (B, M, H, D),
    lane slices of the packed qkv buffer taken in place; wp (dim_out,
    H*D), torch's Linear layout (the transpose of JAX's (H*D, dim_out)),
    cast to q's dtype; bp (dim_out,), added in fp32; residual (B, N,
    dim_out). On CUDA, with no gradient to record (serving), one launch of
    ``csrc/attn_proj.cu`` (B15); under autograd the unfused forward of
    :class:`_AttentionProj`, as the JAX ``custom_vjp`` runs its unfused
    forward for grad. The JAX dispatch limits that exist for VMEM and the
    128 lanes (``_attn_proj_supported``, the packed grid's
    ``_packed_supported``) are not reproduced: their fallbacks compute the
    same function. The kernel takes bf16 and head_dim 64 (every stage-1
    config's), and raises otherwise.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    wp = wp.to(q.dtype)
    residual = residual.to(q.dtype)
    if use_kernel(q, k, v, wp, bp, residual, op="attn_proj"):
        bp = bp.float()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, wp, bp, residual)):
            return _AttentionProj.apply(q, k, v, wp, bp, residual,
                                        float(scale), mask_mode,
                                        int(cond_len))
        return attn_proj_kernel(q, k, v, wp.contiguous(), bp.contiguous(),
                                residual.contiguous(), float(scale),
                                mask_mode, int(cond_len))
    return attention_proj_plain(q, k, v, wp, bp, residual, float(scale),
                                mask_mode, int(cond_len))
