"""Dispatch rule and launch counters shared by the op library.

The rule is the tensor's device: a CUDA tensor goes to the hand-written
kernel (``csrc/``), a CPU tensor goes to the plain PyTorch version beside
it. A CUDA tensor of a shape or dtype a kernel does not take raises; it
never falls back to the plain version.

One scoped exception, :class:`force_plain_ops`: the region that R1
differentiates twice runs every op on its plain version, as the JAX
package runs it under ``force_xla_ops``; the calls it routes are counted
in ``PLAIN_CALLS``.
"""
from __future__ import annotations

import torch

# Kernel launches since the last reset_launches(), by kernel name. Each
# wrapper adds one where it launches its kernel and nowhere else, so a run
# can show that its main path went through the kernels.
LAUNCHES: dict[str, int] = {"ln_gemm": 0, "attention": 0, "layernorm": 0,
                            "vq": 0, "attention_bwd": 0, "fir": 0,
                            "fused_act": 0, "attention_bnhd": 0,
                            "decode_attention": 0, "cache_row_update": 0,
                            "ln_shift_gemm": 0, "int8_gemm": 0,
                            "int8_ln_gemm": 0, "int8_mlp": 0,
                            "attn_proj": 0, "ffn": 0, "attention_bhnd": 0,
                            "attention_fused_bnhd": 0,
                            "attention_gridchunk": 0}
# The fp32 launches among them (csrc/attention_f32.cu's, counted in
# LAUNCHES under the name of the bf16 kernel they stand beside too).
F32_LAUNCHES: dict[str, int] = {name: 0 for name in LAUNCHES}
# Op calls on CUDA tensors that force_plain_ops sent to the plain version.
PLAIN_CALLS: dict[str, int] = {name: 0 for name in LAUNCHES}

_FORCE_PLAIN_DEPTH = 0


def reset_launches() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


class force_plain_ops:
    """Run every op of the region on its plain PyTorch version, CUDA
    tensors included.

    The kernels' ``autograd.Function``s give a first-order gradient only;
    the lazy R1 penalty differentiates the discriminator's input gradient
    a second time, so that region runs on the plain versions, which
    autograd differentiates to any order: the counterpart of the JAX
    package's ``force_xla_ops`` (``enhancing_tpu/ops/common.py:31-49``).
    Nothing else uses it.
    """

    def __enter__(self):
        global _FORCE_PLAIN_DEPTH
        _FORCE_PLAIN_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _FORCE_PLAIN_DEPTH
        _FORCE_PLAIN_DEPTH -= 1
        return False


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_positions(cur_len, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position as an int32 (B,) tensor on ``device``."""
    cur = torch.as_tensor(cur_len, device=device).to(torch.int32)
    return cur.reshape(-1).expand(b).contiguous()


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for CUDA where there is no card raises; nothing
    falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def use_kernel(*tensors: torch.Tensor | None, op: str | None = None) -> bool:
    """True when the tensors lie on a CUDA device (run the kernel), False on
    the CPU (run the plain version) and inside :class:`force_plain_ops`,
    where the call is counted under ``op``. Mixed or other devices raise."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cuda"}:
        if _FORCE_PLAIN_DEPTH:
            if op is not None:
                PLAIN_CALLS[op] += 1
            return False
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got "
                     f"{sorted(devices)}")


def check_kernel_args(name: str, *tensors: torch.Tensor | None,
                      strided_rows: bool = False) -> None:
    """Checks every wrapper makes before it hands pointers to a kernel:
    contiguous, 16-byte aligned memory (the kernels load 16-byte vectors),
    or with ``strided_rows`` a (B, N, C) view whose rows each start 16-byte
    aligned at a common stride (a lane slice of a wider buffer); one
    device; and no autograd graph.

    A raw launch records nothing for autograd, so a kernel reached with
    tensors that need a gradient while grad mode is on raises rather than
    drop the gradient. Kernels with a backward are launched inside their
    ``torch.autograd.Function``'s forward, where grad mode is off; the VQ
    search gets detached inputs, its indices having no gradient."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if strided_rows:
            aligned = (t.dim() == 3 and t.stride(2) == 1
                       and t.stride(0) == t.shape[1] * t.stride(1)
                       and (t.stride(1) * t.element_size()) % 16 == 0)
        else:
            aligned = t.is_contiguous()
        if not aligned or t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must be contiguous "
                             "(or rows at a common stride) and 16-byte "
                             "aligned")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: a raw kernel launch records no gradient; call the "
                "op's differentiable entry point or detach the inputs")
