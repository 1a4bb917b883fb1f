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

Two more entry points serve the stage-2 GPT prior:

- :func:`multihead_attention_bnhd`, the counterpart of the JAX function of
  that name (``attention.py:1810-1855``), takes separate (B, N, H, D) q, k
  and v; on CUDA ``csrc/attention_bnhd.cu`` (the counterpart of
  ``_attention_packed_call``) reads them in place at any N, N = 1
  included, and any head dim of 32, 64, 128 or 384 (the prior's). Same
  numerics as above. It has no backward yet: the prior's training step is
  a later slice.
- :func:`decode_attention` and :func:`decode_attention_stacked`, one
  token's attention against the rows < cur_len of a KV cache plus the
  token's own key and value (``attention.py:1722-1807``); on CUDA
  ``csrc/decode_attention.cu`` (the counterpart of ``_decode_pallas``)
  selects the layer of a stacked cache inside the kernel. The plain
  version is ``_decode_xla`` (``attention.py:1314-1338``) on the layer's
  slice; both clamp a per-row cur_len to [0, ctx], as its mask does. The
  int8 cache (``k_scale``/``v_scale``) is a later slice.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .common import LAUNCHES, check_kernel_args, row_positions, use_kernel

NEG_INF = -1e30
MASK_MODES = {"none": 0, "prefix_causal": 1}
KERNEL_HEAD_DIMS = (32, 64, 128)
BNHD_HEAD_DIMS = (32, 64, 128, 384)
DECODE_CHUNK = 32  # keys per block of csrc/decode_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def attention_bnhd_plain(q, k, v, scale, mask_mode="none", cond_len=0):
    """Plain version of the separate-q/k/v kernel on (B, N, H, D) tensors:
    q scaled in its dtype, then :func:`attention_plain`."""
    q = q * torch.tensor(scale, dtype=q.dtype)
    out = attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), 1.0, mask_mode, cond_len)
    return out.transpose(1, 2)


def attention_bnhd_kernel(q, k, v, scale, mask_mode="none", cond_len=0):
    """Launch ``csrc/attention_bnhd.cu`` on CUDA bf16 (B, N, H, D) q, k, v
    (self-attention: the same N), each a view whose (B, N, H*D) rows lie at
    a common 16-byte aligned stride. Returns a contiguous (B, N, H, D)."""
    b, n, h, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("attention_bnhd kernel takes bf16 q, k, v")
    if d not in BNHD_HEAD_DIMS:
        raise ValueError(f"attention_bnhd kernel takes head_dim in "
                         f"{BNHD_HEAD_DIMS}, got {d}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_bnhd kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    q3, k3, v3 = (t.reshape(b, n, h * d) for t in (q, k, v))
    check_kernel_args("attention_bnhd", q3, k3, v3, strided_rows=True)
    out = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    # the TPU wrapper scales q by the scale rounded to q's dtype
    scale_c = float(torch.tensor(scale, dtype=q.dtype))
    cuda_lib.call("etk_attention_bnhd",
                  *(t.data_ptr() for t in (q3, k3, v3, out)),
                  *(t.stride(1) for t in (q3, k3, v3, out)), b, n, h, d,
                  scale_c, MASK_MODES[mask_mode], int(cond_len),
                  cuda_lib.stream())
    LAUNCHES["attention_bnhd"] += 1
    return out.view(b, n, h, d)


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


def decode_attention_kernel(q3, k_stack, v_stack, kn, vn, cur_len, layer,
                            head_dim):
    """Launch ``csrc/decode_attention.cu`` on CUDA q3, kn, vn (B, H*D) and
    a stacked (L, B, M, H*D) cache of one dtype (bf16 or f32); ``layer``
    is resolved inside the kernel. cur_len: int or (B,) tensor."""
    l, b, m, hd = k_stack.shape
    dtype = k_stack.dtype
    if dtype not in _DTYPES or any(t.dtype != dtype
                                   for t in (q3, v_stack, kn, vn)):
        raise TypeError("decode_attention kernel takes one dtype, bf16 or "
                        "f32, for q, the cache and the new key and value")
    if v_stack.shape != k_stack.shape or any(
            t.shape != (b, hd) for t in (q3, kn, vn)):
        raise ValueError(f"decode_attention kernel: q {tuple(q3.shape)}, "
                         f"cache {tuple(k_stack.shape)}, new "
                         f"{tuple(kn.shape)} {tuple(vn.shape)} do not fit")
    if hd % head_dim or (head_dim * k_stack.element_size()) % 16:
        raise ValueError(f"decode_attention kernel: head_dim {head_dim} of "
                         f"{hd} lanes (16-byte head rows)")
    if not 0 <= layer < l:
        raise IndexError(f"layer {layer} of a stack of {l}")
    heads = hd // head_dim
    _check_decode_len(cur_len, m)
    if isinstance(cur_len, int):
        cur_vec, n_splits = None, max(1, -(-cur_len // DECODE_CHUNK))
    else:
        cur_vec = row_positions(cur_len, b, k_stack.device)
        n_splits = -(-m // DECODE_CHUNK)
    check_kernel_args("decode_attention", q3, k_stack, v_stack, kn, vn,
                      cur_vec)
    ws = torch.empty(b * heads * n_splits * (head_dim + 2),
                     dtype=torch.float32, device=q3.device)
    out = torch.empty((b, hd), dtype=dtype, device=q3.device)
    cuda_lib.call("etk_decode_attention",
                  *(t.data_ptr() for t in (q3, k_stack, v_stack, kn, vn)),
                  None if cur_vec is None else cur_vec.data_ptr(),
                  cur_len if cur_vec is None else 0, int(layer), b, m, heads,
                  head_dim, n_splits, ws.data_ptr(), out.data_ptr(),
                  _DTYPES[dtype], cuda_lib.stream())
    LAUNCHES["decode_attention"] += 1
    return out


def _no_int8_cache(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the int8 KV cache (k_scale / v_scale) is ported with int8 "
            "serving, a later slice of the port (ROADMAP A8)")


def decode_attention(q3: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cur_len, *, head_dim: int,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """One token's attention, packed (B, H*D) layout.

    q3: the current token's query, softmax scale folded in; k_cache,
    v_cache: (B, ctx, H*D), rows < cur_len valid; k_new, v_new: (B, H*D),
    the current token's key and value (not in the cache); cur_len: an int
    or a (B,) tensor of per-row lengths. Returns (B, H*D).
    """
    _no_int8_cache(k_scale, v_scale)
    if use_kernel(q3, k_cache, v_cache, k_new, v_new, op="decode_attention"):
        return decode_attention_kernel(q3, k_cache[None], v_cache[None],
                                       k_new, v_new, cur_len, 0, head_dim)
    return decode_attention_plain(q3, k_cache, v_cache, k_new, v_new,
                                  cur_len, head_dim)


def decode_attention_stacked(q3: torch.Tensor, k_stack: torch.Tensor,
                             v_stack: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, cur_len, layer: int, *,
                             head_dim: int, k_scale=None,
                             v_scale=None) -> torch.Tensor:
    """:func:`decode_attention` against layer ``layer`` of a stacked
    (L, B, ctx, H*D) cache; on CUDA the kernel selects the layer itself."""
    _no_int8_cache(k_scale, v_scale)
    if use_kernel(q3, k_stack, v_stack, k_new, v_new, op="decode_attention"):
        return decode_attention_kernel(q3, k_stack, v_stack, k_new, v_new,
                                       cur_len, int(layer), head_dim)
    return decode_attention_plain(q3, k_stack[layer], v_stack[layer], k_new,
                                  v_new, cur_len, head_dim)
