"""Weights-only int8 products of the decode step.

Counterpart of ``enhancing_tpu/ops/int8.py`` (its weights-only part): a
GEMM's weight is stored as int8 with one fp32 scale per output channel,
``w ~= w_q * scale[:, None]``, which halves the weight bytes that a decode
step, bound by them, reads. The scale is constant along the contraction
axis, so ``(x @ w_q^T) * scale`` is exact in the factorisation.

- :func:`quantize_channelwise`: the symmetric per-channel quantisation.
- :func:`int8_gemm` (``csrc/int8_gemm.cu``): ``act((x @ w_q^T) * scale +
  b) [+ residual]``.
- :func:`int8_ln_gemm` (``csrc/int8_ln_gemm.cu``): LayerNorm, the token
  shift (``tm`` None skips it), the product; returns ``(y, LN(x))``.
- :func:`int8_mlp_decode` (``csrc/int8_mlp.cu``): the whole pre-norm MLP
  ``residual + (act(LN(x) @ w0_q^T * s0 + b0) @ w1_q^T) * s1 + b1`` in one
  launch (:func:`int8_mlp_plan` mirrors its launch).

All three run on the tensor cores (``csrc/int8_wgmma.cuh``): the int8
weights, widened exactly to bf16, times exact bf16 pieces of the
activations (three of an fp32 value, one of a bf16 one), which are the fp32
products of the JAX function; each 128-wide k stage is summed on a fresh
fp32 accumulator and folded into the running sum. The two GEMMs share
``csrc/int8_gemm.cuh``, whose launch :func:`int8_gemm_plan` mirrors: K is
split so that the units fill the SMs, and the splits' fp32 partials are
summed in split order.

Numerics are the Pallas kernels': the int8 weight is cast exactly to the
activations' dtype (fp32 on the decode path, whose residual stream is
fp32; bf16 in the prefill), products are summed in fp32, the scale, bias,
activation and residual are applied in fp32, and the result is rounded
once to x's dtype. LN(x) and the hidden are rounded to x's dtype before
their products. Weights use torch's Linear layout, ``w_q: (n, d)``.

A CUDA tensor goes to the kernel, which raises on what it does not take;
a CPU tensor to the plain version beside it. Inference only: a kernel
launch under autograd raises. W8A8 (``act_int8``: int8 activations) is not
here; the JAX package computes it with no Pallas kernel.
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib
from .common import LAUNCHES, cdiv, check_kernel_args, use_kernel
from .ln_gemm import (ACTIVATIONS, DTYPE_CODES, X_DTYPES, _act, bias_code,
                      check_vec, layernorm, ln_kernel_checks, ln_operands,
                      ln_shift_mix)


def quantize_channelwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: ``w ~= w_q * scale[..., None]``.

    w: (..., n, d), the contraction axis last (torch's Linear layout).
    Returns (w_q int8 of w's shape, scale fp32 (..., n)): ``scale =
    max(amax, 1e-12) / 127`` over d, ``w_q = clip(round(w / scale), -127,
    127)``, rounding half to even, as ``quantize_channelwise`` of the JAX
    package computes on its (d, n) kernels. Over the last axis it is also
    the per-row quantisation of int8 KV-cache rows (``GPT._quant_rows``
    there)."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    w_q = torch.round(w32 / scale[..., None]).clamp_(-127, 127)
    return w_q.to(torch.int8), scale


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# csrc/int8_wgmma.cuh: 64 output channels a warpgroup (the wgmma's M),
# 128-k stages, 8 activation rows a tile; a block may use 227 KB of shared
# memory less 2 KB (alignment slack, static barriers)
TILE_N, CHUNK, ROWS, SMEM_LIMIT = 64, 128, 8, 232448 - 2048
# csrc/int8_gemm.cuh: three consumer warpgroups a block, 128-k stages of a
# 192 x 128 int8 weight box, the activations' pieces of a split resident
# in shared memory (8 rows x P pieces x 2 bytes a k)
GEMM_WGS, GEMM_MAX_STAGES, GEMM_MIN_STAGES = 3, 4, 2
GEMM_STAGE_BYTES = GEMM_WGS * TILE_N * CHUNK
# two slots a warpgroup of its fp32 tile sums for the epilogue warps, and
# 1 KB of static barriers and statistics beside the dynamic shared memory
GEMM_SLOT_BYTES = GEMM_WGS * 2 * ROWS * TILE_N * 4
GEMM_SMEM_BUDGET = SMEM_LIMIT - GEMM_SLOT_BYTES - 1024


@functools.lru_cache(maxsize=256)
def int8_gemm_plan(m: int, d: int, n: int, sms: int = 132,
                   pieces: int = 3) -> dict:
    """The launch of the int8 GEMM kernels (B12, and B13, which launches
    the same) for an (m, d) x with an (n, d) weight on a card of ``sms``
    SMs, ``pieces`` bf16 pieces an activation (3 for fp32 x, 1 for bf16),
    as ``csrc/int8_gemm.cuh::make_plan`` makes it (the C entry
    ``etk_int8_gemm_plan`` returns the same numbers):

    - ``row_tiles`` of 8 rows and ``groups`` of 192 output channels (three
      64-channel tiles);
    - ``splits`` of K, ``split_chunks`` 128-wide chunks each (none empty):
      the splits that cost the busiest block least, counted in quarter
      chunks (its units, :func:`_max_units`, times their chunks plus a
      quarter each for the partial, plus one a split for the last
      arriver's reads; fewer splits on a tie), among those whose resident
      pieces leave room for two ring stages;
    - ``grid``: one block an SM, at most one a unit; block b takes units of
      stream (row tile, split) b % streams when there are at least as many
      blocks as streams;
    - ``stages`` of the weight ring (at most 4) and the ``smem`` they, the
      resident pieces and the epilogue warps' slots take (+ 1 KB of
      alignment slack);
    - ``part_bytes`` of fp32 partials and ``sync_words`` (a split count a
      row tile and 64-channel tile) when there is more than one split.

    Cached (the wrappers ask at every call): treat the dict as read-only.
    Raises ValueError for a shape the kernel refuses."""
    if m <= 0 or d <= 0 or n <= 0 or d % 16 or pieces not in (1, 3) \
            or sms <= 0:
        raise ValueError(f"int8 GEMM kernels take m, d, n > 0 with d % 16 "
                         f"== 0 and 1 or 3 pieces; got m={m}, d={d}, n={n}, "
                         f"pieces={pieces}")
    tiles, chunks = cdiv(n, TILE_N), cdiv(d, CHUNK)
    row_tiles, groups = cdiv(m, ROWS), cdiv(tiles, GEMM_WGS)
    res_per_chunk = 2 * ROWS * pieces * 128
    best = None
    for s in range(1, chunks + 1):
        sc = cdiv(chunks, s)
        if cdiv(chunks, sc) != s or (GEMM_SMEM_BUDGET - sc * res_per_chunk
                                     < GEMM_MIN_STAGES * GEMM_STAGE_BYTES):
            continue
        streams = row_tiles * s
        if streams * groups > 2 ** 31 - 1:
            continue
        grid = min(sms, streams * groups)
        cost = (_max_units(groups, streams, grid) * (4 * sc + 1)
                + (s if s > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, s, sc)
    if best is None:
        raise ValueError(f"int8 GEMM kernels: m={m}, n={n} too large")
    _, splits, split_chunks = best
    units = row_tiles * groups * splits
    part = 4 * row_tiles * splits * ROWS * n if splits > 1 else 0
    words = row_tiles * tiles if splits > 1 else 0
    if max(units, part, words) > 2 ** 31 - 1:
        raise ValueError(f"int8 GEMM kernels: m={m}, n={n} too large")
    res = split_chunks * res_per_chunk
    stages = min(GEMM_MAX_STAGES, (GEMM_SMEM_BUDGET - res)
                 // GEMM_STAGE_BYTES)
    return dict(grid=min(sms, units), row_tiles=row_tiles, groups=groups,
                splits=splits, split_chunks=split_chunks, stages=stages,
                smem=res + stages * GEMM_STAGE_BYTES + GEMM_SLOT_BYTES + 1024,
                part_bytes=part, sync_words=words)


def _max_units(groups: int, streams: int, grid: int) -> int:
    """Units of the busiest block: with at least as many blocks as streams
    (a row tile and split each), a block takes units of one stream only;
    with fewer, a contiguous run of all units."""
    if grid >= streams:
        return cdiv(groups, grid // streams)
    return cdiv(groups * streams, grid)


# Persistent scratch of the kernels, one buffer per kind, device and
# stream, made when first asked for and grown when a launch needs more;
# launches on one stream run in order, so they share it. Kinds: "mlp", B14's
# grid barrier words, and "gemm_sync", the GEMMs' split counts, both zero
# when made and left so by every launch (but the barrier's generation);
# "gemm_part", the GEMMs' fp32 partials, rewritten by every launch.
_SCRATCH: dict = {}
# The scratch arguments of a GEMM launch by (x's shape and dtype, n,
# device, stream), cleared whenever a buffer is replaced.
_GEMM_ARGS: dict = {}


def _scratch(kind: str, device: torch.device, stream: int, nbytes: int,
             zero: bool = True) -> torch.Tensor:
    key = (kind, device, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        make = torch.zeros if zero else torch.empty
        buf = make(max(nbytes, 1024), dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
        _GEMM_ARGS.clear()
    return buf


def _gemm_scratch(x: torch.Tensor, n: int, stream: int) -> tuple:
    """(partials, their bytes, split counts, their words) of an int8 GEMM
    launch on x, sized by :func:`int8_gemm_plan`; with one split, no
    scratch. The C entry refuses a launch whose plan needs more."""
    key = (x.shape, x.dtype, n, x.device, stream)
    args = _GEMM_ARGS.get(key)
    if args is not None:
        return args
    plan = int8_gemm_plan(*x.shape, n, _sms(x.device), _pieces(x))
    args = None, 0, None, 0
    if plan["splits"] > 1:
        part = _scratch("gemm_part", x.device, stream, plan["part_bytes"],
                        zero=False)
        sync = _scratch("gemm_sync", x.device, stream,
                        4 * plan["sync_words"])
        args = (part.data_ptr(), part.numel(), sync.data_ptr(),
                sync.numel() // 4)
    _GEMM_ARGS[key] = args
    return args


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = sms
    return sms


def _pieces(x: torch.Tensor) -> int:
    return 3 if x.dtype == torch.float32 else 1


# -- y = act((x @ w_q^T) * scale + b) [+ residual] ----------------------------


def int8_gemm_plain(x, w_q, scale, b=None, residual=None, activation=None):
    """Plain version of the int8 GEMM kernel on 2-D operands."""
    out = x.float() @ w_q.to(x.dtype).float().t()
    out = out * scale.float()
    if b is not None:
        out = out + b.float()
    out = _act(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def int8_gemm_kernel(x, w_q, scale, b=None, residual=None, activation=None):
    """Launch ``csrc/int8_gemm.cu`` on CUDA x (m, d) fp32 or bf16, w_q
    (n, d) int8, scale (n,) fp32, b (n,) fp32 or bf16, residual (m, n)
    fp32; d % 16 == 0. One launch (:func:`int8_gemm_plan`)."""
    m, d = x.shape
    n = w_q.shape[0]
    _check_x("int8_gemm", x)
    if w_q.dtype != torch.int8 or w_q.shape != (n, d) or d % 16:
        raise ValueError(f"int8_gemm kernel takes an int8 (n, {d}) weight "
                         f"with d % 16 == 0, got {tuple(w_q.shape)} "
                         f"{w_q.dtype}")
    check_vec("int8_gemm", "scale", scale, n)
    check_vec("int8_gemm", "bias", b, n, X_DTYPES)
    if residual is not None and (residual.shape != (m, n)
                                 or residual.dtype != torch.float32):
        raise ValueError("int8_gemm kernel takes an fp32 (m, n) residual")
    check_kernel_args("int8_gemm", x, w_q, scale, b, residual)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = cuda_lib.stream()
    cuda_lib.call("etk_int8_gemm", x.data_ptr(), w_q.data_ptr(),
                  scale.data_ptr(), _ptr(b), _ptr(residual), out.data_ptr(),
                  *_gemm_scratch(x, n, stream), m, d, n,
                  ACTIVATIONS[activation], bias_code(b), DTYPE_CODES[x.dtype],
                  stream)
    LAUNCHES["int8_gemm"] += 1
    return out


def int8_gemm(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              b: torch.Tensor | None = None, *,
              activation: str | None = None,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """act((x @ w_q^T) * scale + b) [+ residual] with int8 weights.

    x: (..., d); w_q: (n, d) int8; scale: (n,) fp32; b: (n,) or None;
    residual: (..., n) or None, added after the activation in fp32.
    Returns (..., n) in x's dtype."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape = x.shape[:-1]
    n = w_q.shape[0]
    x2 = x.reshape(-1, x.shape[-1])
    r2 = None if residual is None else residual.reshape(-1, n)
    if use_kernel(x2, w_q, scale, b, r2, op="int8_gemm"):
        out = int8_gemm_kernel(x2.contiguous(), w_q.contiguous(),
                               scale.float().contiguous(),
                               None if b is None else b.contiguous(),
                               None if r2 is None
                               else r2.float().contiguous(), activation)
    else:
        out = int8_gemm_plain(x2, w_q, scale, b, r2, activation)
    return out.reshape(*batch_shape, n)


# -- (act((LN(x) * tm + prev * (1 - tm)) @ w^T * scale + b), LN(x)) -----------


def int8_ln_gemm_plain(x, gamma, beta, tm, prev, w_q, scale, b=None,
                       activation=None, eps=1e-5):
    """Plain version of the int8 LN + shift GEMM kernel on 2-D operands."""
    mixed, xn = ln_shift_mix(x, gamma, beta, tm, prev, eps)
    out = (mixed.float() @ w_q.to(x.dtype).float().t()) * scale.float()
    if b is not None:
        out = out + b.float()
    return _act(out, activation).to(x.dtype), xn


def int8_ln_gemm_kernel(x, gamma, beta, tm, prev, w_q, scale, b=None,
                        activation=None, eps=1e-5):
    """Launch ``csrc/int8_ln_gemm.cu``: x (m, d) fp32 or bf16; fp32
    gamma, beta, tm (d,) (tm None: no shift); prev (m, d) fp32 or bf16;
    w_q (n, d) int8; scale (n,) fp32; b (n,) fp32 or bf16."""
    m, d = x.shape
    n = w_q.shape[0]
    ln_kernel_checks("int8_ln_gemm", x, gamma, beta, tm, prev, n, b)
    if w_q.dtype != torch.int8 or w_q.shape != (n, d):
        raise ValueError(f"int8_ln_gemm kernel takes an int8 (n, {d}) "
                         f"weight, got {tuple(w_q.shape)} {w_q.dtype}")
    check_vec("int8_ln_gemm", "scale", scale, n)
    check_kernel_args("int8_ln_gemm", x, gamma, beta, tm, prev, w_q, scale, b)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xn = torch.empty_like(x)
    stream = cuda_lib.stream()
    cuda_lib.call("etk_int8_ln_gemm", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), _ptr(tm), _ptr(prev), w_q.data_ptr(),
                  scale.data_ptr(), _ptr(b), out.data_ptr(), xn.data_ptr(),
                  *_gemm_scratch(x, n, stream), m, d, n,
                  ACTIVATIONS[activation], eps,
                  0 if prev is None else DTYPE_CODES[prev.dtype],
                  bias_code(b), DTYPE_CODES[x.dtype], stream)
    LAUNCHES["int8_ln_gemm"] += 1
    return out, xn


def int8_ln_gemm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 tm: torch.Tensor | None, prev: torch.Tensor | None,
                 w_q: torch.Tensor, scale: torch.Tensor,
                 b: torch.Tensor | None = None, *,
                 activation: str | None = None, eps: float = 1e-5
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(act((LN(x) * tm + prev * (1 - tm)) @ w_q^T * scale + b), LN(x)).

    x: (..., d); gamma, beta, tm: (d,) (tm None skips the shift and prev);
    prev: (..., d), the previous token's LN output; w_q: (n, d) int8;
    scale: (n,); b: (n,) or None. Returns ((..., n), (..., d)), both in
    x's dtype."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    batch_shape, n = x.shape[:-1], w_q.shape[0]
    x2, g, bt, tm1, p2 = ln_operands(x, gamma, beta, tm, prev)
    if use_kernel(x2, g, bt, tm1, p2, w_q, scale, b, op="int8_ln_gemm"):
        out, xn = int8_ln_gemm_kernel(
            x2, g, bt, tm1, p2, w_q.contiguous(), scale.float().contiguous(),
            None if b is None else b.contiguous(), activation, eps)
    else:
        out, xn = int8_ln_gemm_plain(x2, g, bt, tm1, p2, w_q, scale, b,
                                     activation, eps)
    return out.reshape(*batch_shape, n), xn.reshape(x.shape)


# -- the whole decode MLP -----------------------------------------------------


def int8_mlp_plain(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, residual,
                   activation="sqrelu", eps=1e-5):
    """Plain version of the one-launch MLP kernel on 2-D operands."""
    xn = layernorm(x, gamma, beta, eps)
    h = (xn.float() @ w0_q.to(x.dtype).float().t()) * s0.float()
    if b0 is not None:
        h = h + b0.float()
    h = _act(h, activation).to(x.dtype)
    acc = h.float() @ w1_q.to(x.dtype).float().t()
    res = residual.float()
    if b1 is not None:
        res = res + b1.float()
    return (acc * s1.float() + res).to(x.dtype)


# csrc/int8_mlp.cu: three consumer warpgroups of 64 channels a block, 128-k
# stages (a 192 x 128 int8 weight box and two 64-k boxes of 8 x P bf16
# activation pieces), at most 6 stages
MLP_WGS, MLP_MAX_STAGES = 3, 6


def int8_mlp_plan(m: int, d: int, h: int, sms: int = 132,
                  pieces: int = 3) -> dict:
    """The int8 MLP kernel's launch for an (m, d) x with hidden width h on a
    card of ``sms`` SMs, ``pieces`` bf16 pieces an activation (3 for fp32
    x, 1 for bf16), as ``csrc/int8_mlp.cu`` makes it (the C entry
    ``etk_int8_mlp_plan`` returns the same numbers):

    - ``groups_b``: phase B units, 192 hidden channels each over all of d;
    - ``splits`` of the hidden axis in phase C (``split_chunks`` 128-wide
      chunks each, none empty) and ``groups_c`` units, 192 output channels
      of one split each, as many as fill the SMs;
    - ``grid``: one block an SM, at most one a unit of the larger phase;
    - ``stages`` of the TMA ring and the ``smem`` they take (+ 1 KB of
      alignment slack);
    - ``ws_bytes``: LN(x)'s and the hidden's pieces (8 P rows of d and of
      h bf16) and, with more than one split, the fp32 partials;
    - ``sync_words``: the persistent grid barrier's count and generation
      and one arrival count an output tile of 64.

    Raises ValueError for a shape the kernel refuses."""
    if m <= 0 or d <= 0 or h <= 0 or d % 16 or h % 16 or pieces not in (1, 3):
        raise ValueError(f"int8_mlp kernel takes m, d, h > 0 with d and h % "
                         f"16 == 0 and 1 or 3 pieces; got m={m}, d={d}, "
                         f"h={h}, pieces={pieces}")
    tiles_c = cdiv(d, TILE_N)
    groups_c0, chunks_c = cdiv(tiles_c, MLP_WGS), cdiv(h, CHUNK)
    groups_b = cdiv(cdiv(h, TILE_N), MLP_WGS)
    split_chunks = cdiv(chunks_c, max(1, min(sms // groups_c0, chunks_c)))
    splits = cdiv(chunks_c, split_chunks)
    groups_c = groups_c0 * splits
    stage = MLP_WGS * TILE_N * CHUNK + 2 * ROWS * pieces * 128
    stages = min(MLP_MAX_STAGES, SMEM_LIMIT // stage)
    ws = 2 * ROWS * pieces * (d + h)
    if splits > 1:
        ws += 4 * splits * ROWS * d
    return dict(grid=max(1, min(sms, max(groups_b, groups_c))),
                groups_b=groups_b, groups_c=groups_c, splits=splits,
                split_chunks=split_chunks, stages=stages,
                smem=stages * stage + 1024, ws_bytes=ws,
                sync_words=2 + tiles_c)


def int8_mlp_kernel(x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, residual,
                    activation="sqrelu", eps=1e-5):
    """Launch ``csrc/int8_mlp.cu``: x (m, d) fp32 or bf16, w0_q (h, d) and
    w1_q (d, h) int8 with fp32 scales, biases fp32 or bf16 (one dtype),
    residual (m, d) fp32; d and h % 16 == 0. One cooperative launch; it
    raises if the card cannot hold its grid at once."""
    m, d = x.shape
    h = w0_q.shape[0]
    _check_x("int8_mlp", x)
    if (w0_q.dtype != torch.int8 or w1_q.dtype != torch.int8
            or w0_q.shape != (h, d) or w1_q.shape != (d, h)
            or d % 16 or h % 16):
        raise ValueError(f"int8_mlp kernel takes int8 w0_q (h, {d}) and "
                         f"w1_q ({d}, h), d and h % 16 == 0; got "
                         f"{tuple(w0_q.shape)}, {tuple(w1_q.shape)}")
    for what, t, size in (("gamma", gamma, d), ("beta", beta, d),
                          ("s0", s0, h), ("s1", s1, d)):
        check_vec("int8_mlp", what, t, size)
    check_vec("int8_mlp", "b0", b0, h, X_DTYPES)
    check_vec("int8_mlp", "b1", b1, d, X_DTYPES)
    if b0 is not None and b1 is not None and b0.dtype != b1.dtype:
        raise TypeError("int8_mlp kernel takes b0 and b1 of one dtype")
    if residual.shape != (m, d) or residual.dtype != torch.float32:
        raise ValueError("int8_mlp kernel takes an fp32 (m, d) residual")
    check_kernel_args("int8_mlp", x, gamma, beta, w0_q, s0, b0, w1_q, s1, b1,
                      residual)
    if any(t.data_ptr() % 16 for t in (x, gamma, beta, w0_q, w1_q)):
        raise ValueError("int8_mlp kernel needs x, gamma, beta and the "
                         "weights 16-byte aligned")
    plan = int8_mlp_plan(m, d, h, _sms(x.device), _pieces(x))
    out = torch.empty_like(x)
    ws = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=x.device)
    stream = cuda_lib.stream()
    sync = _scratch("mlp", x.device, stream, 4 * plan["sync_words"])
    bias = b0 if b0 is not None else b1
    cuda_lib.call("etk_int8_mlp", x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), w0_q.data_ptr(), s0.data_ptr(), _ptr(b0),
                  w1_q.data_ptr(), s1.data_ptr(), _ptr(b1),
                  residual.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  sync.data_ptr(), m, d, h, ACTIVATIONS[activation], eps,
                  bias_code(bias), DTYPE_CODES[x.dtype], stream)
    LAUNCHES["int8_mlp"] += 1
    return out


def int8_mlp_decode(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w0_q: torch.Tensor, s0: torch.Tensor,
                    b0: torch.Tensor | None, w1_q: torch.Tensor,
                    s1: torch.Tensor, b1: torch.Tensor | None,
                    residual: torch.Tensor, *, activation: str = "sqrelu",
                    eps: float = 1e-5) -> torch.Tensor:
    """residual + (act(LN(x) @ w0_q^T * s0 + b0) @ w1_q^T) * s1 + b1, the
    whole pre-norm MLP over int8 weights as one kernel.

    x, residual: (..., d); w0_q: (h, d), w1_q: (d, h) int8; s0 (h,), s1
    (d,) fp32; b0 (h,), b1 (d,) or None. Returns (..., d) in x's dtype."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    r2 = residual.reshape(-1, d)
    if use_kernel(x2, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, r2,
                  op="int8_mlp"):
        out = int8_mlp_kernel(
            x2, gamma.float().contiguous(), beta.float().contiguous(),
            w0_q.contiguous(), s0.float().contiguous(),
            None if b0 is None else b0.contiguous(), w1_q.contiguous(),
            s1.float().contiguous(), None if b1 is None else b1.contiguous(),
            r2.float().contiguous(), activation, eps)
    else:
        out = int8_mlp_plain(x2, gamma, beta, w0_q, s0, b0, w1_q, s1, b1, r2,
                             activation, eps)
    return out.reshape(x.shape)
