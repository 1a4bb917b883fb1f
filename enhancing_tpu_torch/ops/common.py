"""Dispatch rule and launch counters shared by the op library.

The rule is the tensor's device: a CUDA tensor goes to the hand-written
kernel (``csrc/``), a CPU tensor goes to the plain PyTorch version beside
it. A CUDA tensor of a shape or dtype a kernel does not take raises; it
never falls back to the plain version.
"""
from __future__ import annotations

import torch

# Kernel launches since the last reset_launches(), by kernel name. Each
# wrapper adds one where it launches its kernel and nowhere else, so a run
# can show that its main path went through the kernels.
LAUNCHES: dict[str, int] = {"ln_gemm": 0, "attention": 0, "layernorm": 0,
                            "vq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for CUDA where there is no card raises; nothing
    falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def use_kernel(*tensors: torch.Tensor | None) -> bool:
    """True when the tensors lie on a CUDA device (run the kernel), False on
    the CPU (run the plain version). Mixed or other devices raise."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got "
                     f"{sorted(devices)}")


def check_kernel_args(name: str, *tensors: torch.Tensor | None) -> None:
    """Checks every wrapper makes before it hands pointers to a kernel:
    contiguous, 16-byte aligned memory (the kernels load 16-byte vectors),
    one device, and no autograd (the kernels have no backward yet;
    training is a later slice of the port)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must be contiguous and "
                             "16-byte aligned")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: the CUDA kernel has no backward; run under "
                "torch.no_grad() or torch.inference_mode()")
