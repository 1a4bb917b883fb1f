"""enhancing_tpu_torch — the PyTorch/CUDA port of enhancing_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper,
sm_90a). Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a kernel written by hand in CUDA C++ (``csrc/``), built at
first use and bound with ctypes (``ops/cuda_lib.py``). The port imports
nothing of ``enhancing_tpu`` and nothing of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a model built for ``cuda`` on a machine with no card raises. On the CPU
every op runs its plain PyTorch version.
"""

__version__ = "0.1.0"

# Lazy top-level exports (PEP 562): `from enhancing_tpu_torch import ViTVQ`
# without importing the model modules at package-import time.
_EXPORTS = {
    "ViTVQ": "enhancing_tpu_torch.models.stage1.vitvqgan",
    "ViTVQGumbel": "enhancing_tpu_torch.models.stage1.vitvqgan",
    "load_config": "enhancing_tpu_torch.utils.config",
    "initialize_from_config": "enhancing_tpu_torch.utils.config",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'enhancing_tpu_torch' has no attribute {name!r}")
