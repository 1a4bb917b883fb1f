"""Self-attention straight off the fused qkv projection output.

Counterpart of ``multihead_attention_packed_qkv`` in
``enhancing_tpu/ops/attention.py``. On CUDA the kernel
``csrc/attention.cu`` reads q, k and v in place from the (B, N, 3*H*D)
buffer; the plain version splits it, as ``_qkv_split_scaled`` and
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
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, use_kernel

NEG_INF = -1e30
MASK_MODES = {"none": 0, "prefix_causal": 1}
KERNEL_HEAD_DIMS = (32, 64, 128)


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
    """Launch ``csrc/attention.cu`` on a CUDA bf16 (B, N, 3*H*D) tensor."""
    b, n, hd3 = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"attention kernel takes bf16, got {qkv.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {head_dim}")
    if hd3 != 3 * heads * head_dim:
        raise ValueError(f"qkv last dim {hd3} != 3 * {heads} * {head_dim}")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    check_kernel_args("attention", qkv)
    out = torch.empty((b, n, heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    # the TPU kernel scales the bf16 q tile by the scale rounded to bf16
    scale_c = float(torch.tensor(scale, dtype=qkv.dtype))
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
    scaled), k, v and dO, each contiguous or a lane slice of a wider buffer
    with 16-byte aligned rows. Returns contiguous dq, dk and dv."""
    b, n, hd = q3.shape
    if any(t.dtype != torch.bfloat16 for t in (q3, k3, v3, do3)):
        raise TypeError("attention backward kernel takes bf16 q, k, v, dO")
    if head_dim not in KERNEL_HEAD_DIMS or hd != heads * head_dim:
        raise ValueError(f"attention backward kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and H*D lanes, got "
                         f"{tuple(q3.shape)} for {heads} x {head_dim}")
    if any(t.shape != q3.shape for t in (k3, v3, do3)):
        raise ValueError("attention backward: q, k, v and dO shapes differ")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    check_kernel_args("attention_bwd", q3, k3, v3, do3, strided_rows=True)
    grads = [torch.empty((b, n, hd), dtype=q3.dtype, device=q3.device)
             for _ in range(3)]
    n_pad = -(-n // 64) * 64
    stats = torch.empty((3, b, heads, n_pad), dtype=torch.float32,
                        device=q3.device)
    cuda_lib.call("etk_attention_bwd",
                  *(t.data_ptr() for t in (q3, k3, v3, do3, *grads, stats)),
                  *(t.stride(1) for t in (q3, k3, v3, do3, *grads)),
                  b, n, heads, head_dim, MASK_MODES[mask_mode],
                  int(cond_len), cuda_lib.stream())
    LAUNCHES["attention_bwd"] += 1
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
