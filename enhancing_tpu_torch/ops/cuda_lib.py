"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file; the objects are
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``. The build runs at first use, into ``build/`` beside the
package, keyed by a hash of the sources and flags, so a fresh checkout
builds everything itself and an unchanged tree reuses its library.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong
# C entry points (see each csrc/*.cu); all return a cudaError_t, -1 for
# arguments the kernel does not take, or -2 for a TMA tensor map that could
# not be encoded.
SIGNATURES = {
    "etk_ln_gemm": [_p] * 7 + [_i, _i, _i, _i, _f, _i, _p],
    "etk_ln_gemm_plan": [_i, _i, ctypes.POINTER(_i)],
    "etk_ln_gemm_f32": [_p] * 8 + [_i, _i, _i, _i, _f, _i, _p],
    "etk_ln_gemm_f32_plan": [_i] * 4 + [ctypes.POINTER(_i)],
    "etk_layernorm": [_p, _p, _p, _p, _i, _i, _f, _i, _p],
    "etk_layernorm_plan": [_i, _i, _i, ctypes.POINTER(_i)],
    "etk_attention_qkv": [_p, _p, _i, _i, _i, _i, _f, _i, _i, _p],
    "etk_vq_nearest": [_p, _p, _p, _p, _i, _i, _i, _p],
    "etk_vq_plan": [_i, _i, _i, ctypes.POINTER(_i)],
    "etk_attention_bwd": [_p] * 8 + [_i] * 13 + [_p],
    "etk_attention_bwd_f32": [_p] * 9 + [_i] * 13 + [_p],
    "etk_attention_bwd_wide": [_p] * 9 + [_i] * 13 + [_p],
    "etk_fir": [_p, _p, ctypes.POINTER(_f)] + [_i] * 11 + [_p],
    "etk_fir_plan": [_i] * 7 + [ctypes.POINTER(_i)],
    "etk_fused_act": [_p, _p, _p, ctypes.c_longlong, _i, _f, _f, _i, _p],
    "etk_attention_bnhd": [_p] * 4 + [ctypes.POINTER(_i)] + [_i] * 5
    + [_f, _i, _i, _i, _p],
    "etk_attention_f32": [_p] * 4 + [ctypes.POINTER(_i), _p] + [_i] * 5
    + [_f, _i, _i, _i, _p],
    "etk_decode_attention": [_p] * 6 + [_i] * 6 + [_p] * 3 + [_i, _i, _p],
    "etk_decode_plan": [_i, _i, ctypes.POINTER(_i)],
    "etk_cache_row_update": [_p] * 3 + [_i] * 5 + [_p],
    "etk_cache_row_update_bulk": [_p] * 3 + [_i] * 8 + [_p],
    "etk_int8_gemm": [_p] * 7 + [_ll, _p, _ll] + [_i] * 6 + [_p],
    "etk_int8_gemm_plan": [_i, _i, _i, _i, ctypes.POINTER(_i)],
    "etk_int8_ln_gemm": [_p] * 11 + [_ll, _p, _ll] + [_i] * 4
    + [_f, _i, _i, _i, _p],
    "etk_ln_shift_gemm": [_p] * 10 + [_ll, _p, _ll] + [_i] * 4
    + [_f, _i, _i, _i, _i, _p],
    "etk_ln_shift_gemm_plan": [_i] * 5 + [ctypes.POINTER(_i)],
    "etk_int8_mlp": [_p] * 13 + [_i] * 4 + [_f, _i, _i, _p],
    "etk_int8_mlp_plan": [_i, _i, _i, _i, ctypes.POINTER(_i)],
    "etk_attn_proj": [_p] * 7 + [_i] * 9 + [_f, _i, _i, _p],
    "etk_attn_proj_f32": [_p] * 8 + [_i] * 9 + [_f, _i, _i, _p],
    "etk_ffn": [_p] * 6 + [_i] * 4 + [_p],
    "etk_ffn_f32": [_p] * 7 + [_i] * 4 + [_p],
    "etk_ffn_plan": [_i, ctypes.POINTER(_i)],
    "etk_ffn_f32_plan": [_i, ctypes.POINTER(_i)],
    "etk_attn_proj_plan": [_i, ctypes.POINTER(_i)],
    "etk_attn_proj_f32_plan": [_i, _i, _i, ctypes.POINTER(_i)],
    "etk_wgmma_probe": [_p, _p, _p, _i, _p],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree's library is not built yet; return
    its path. Records seconds and the ptxas report in ``build_info``."""
    out_dir = BUILD_ROOT / f"kernels-{_digest()}"
    lib_path = out_dir / "libenhancing_kernels.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log="")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        log = "\n".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.etk_error_string.argtypes = [ctypes.c_int]
        handle.etk_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def plan(name: str, *args: int, size: int = 5) -> tuple:
    """The ``size`` integers that C entry ``name`` (a kernel's host-side
    tile or cluster choice) writes for ``args`` on this device."""
    out = (_i * size)()
    call(name, *args, out)
    return tuple(out)


def stream() -> int:
    """The raw handle of the current CUDA stream of the current device:
    what ``torch.cuda.current_stream().cuda_stream`` gives, read without
    building a Stream object (0.1-0.4 us a call against 4-7 us on an NVIDIA
    H100 80GB HBM3 at 700 W, ``ab_cache_row_update.py``): every wrapper
    asks at each launch."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def call(name: str, *args) -> None:
    """Launch C entry ``name`` and raise if the launch was refused."""
    handle = lib()
    rc = getattr(handle, name)(*args)
    if rc != 0:
        msg = {-1: "arguments the kernel does not take",
               -2: "a TMA tensor map could not be encoded"}.get(rc)
        msg = msg or handle.etk_error_string(rc).decode()
        raise RuntimeError(f"{name} failed ({rc}): {msg}")
