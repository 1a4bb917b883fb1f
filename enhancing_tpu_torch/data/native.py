"""ctypes bindings for the repository's native (C++) image ops.

The port's copy of ``enhancing_tpu/data/native.py``: it wraps the
library that ``native/build.py`` builds from ``native/image_ops.cpp`` at
first use (with libjpeg / libpng where the machine has their development
files, else without decoders), as the JAX package does. Where the library
does not load, a warning says so and the loaders decode through Pillow
(``transforms.load_image``); where it loads without decoders,
:func:`has_decoders` is False and they do the same.
"""
from __future__ import annotations

import ctypes
import warnings

import numpy as np

_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from pathlib import Path
        import sys
        root = Path(__file__).resolve().parents[2]
        sys.path.insert(0, str(root / "native"))
        try:
            from build import build  # type: ignore
        finally:
            sys.path.pop(0)
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.resize_bilinear_u8.argtypes = [u8p, i64, i64, i64, u8p, i64, i64]
        lib.crop_flip_normalize.argtypes = [u8p, i64, i64, i64, i64, i64, i64,
                                            ctypes.c_int, f32p]
        lib.u8_to_f32.argtypes = [u8p, f32p, i64]
        i64p = ctypes.POINTER(i64)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.has_decoders.restype = ctypes.c_int
        lib.decode_image_u8.argtypes = [u8p, i64, u8p, i64, i64p, i64p]
        lib.decode_image_u8.restype = ctypes.c_int
        lib.decode_image_dims.argtypes = [u8p, i64, i64p, i64p]
        lib.decode_image_dims.restype = ctypes.c_int
        lib.decode_pipeline_batch.argtypes = [
            i64, ctypes.POINTER(u8p), i64p, i64, i64, i64p, i64p, intp,
            f32p, intp]
        _lib = lib
    except Exception as e:  # toolchain missing etc.
        warnings.warn(f"native image ops unavailable ({e}); "
                      "using numpy/PIL fallback")
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """HWC uint8 bilinear resize via the native lib."""
    lib = get_lib()
    assert lib is not None and img.dtype == np.uint8
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    lib.resize_bilinear_u8(_u8ptr(img), h, w, c, _u8ptr(out), oh, ow)
    return out


def crop_flip_normalize(img: np.ndarray, top: int, left: int, size: int,
                        flip: bool) -> np.ndarray:
    lib = get_lib()
    assert lib is not None and img.dtype == np.uint8
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((size, size, c), np.float32)
    lib.crop_flip_normalize(_u8ptr(img), h, w, c, top, left, size,
                            int(flip), _f32ptr(out))
    return out


def has_decoders() -> bool:
    """True when the library was built against libjpeg/libpng."""
    lib = get_lib()
    return lib is not None and lib.has_decoders() != 0


def decode_image(data: bytes) -> np.ndarray:
    """In-memory JPEG/PNG decode to RGB uint8 HWC via the native lib.

    Raises ValueError for undecodable bytes (caller falls back to PIL,
    which also handles the formats the native path doesn't — webp etc.).
    """
    import ctypes
    lib = get_lib()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    if not lib.decode_image_dims(_u8ptr(buf), len(data),
                                 ctypes.byref(h), ctypes.byref(w)):
        raise ValueError("native decode failed")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if not lib.decode_image_u8(_u8ptr(buf), len(data), _u8ptr(out),
                               out.size, ctypes.byref(h), ctypes.byref(w)):
        raise ValueError("native decode failed")
    return out


def decode_pipeline_batch(blobs, resize_short: int, size: int,
                          tops, lefts, flips):
    """Threaded decode -> shorter-side resize -> crop -> flip -> normalize.

    Args:
      blobs: list of bytes (encoded JPEG/PNG).
      resize_short: target shorter side (0 = no resize).
      size: square crop size.
      tops/lefts: per-image crop offsets (clamped inside).
      flips: per-image horizontal-flip booleans.
    Returns (batch (n, size, size, 3) float32 in [0,1], ok bool (n,)).
    """
    import ctypes
    lib = get_lib()
    assert lib is not None
    n = len(blobs)
    arrays = [np.frombuffer(b, np.uint8) for b in blobs]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * n)(*[a.ctypes.data_as(u8p) for a in arrays])
    lens = np.asarray([len(b) for b in blobs], np.int64)
    tops = np.asarray(tops, np.int64)
    lefts = np.asarray(lefts, np.int64)
    flips_arr = np.asarray(flips, np.int32)
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.decode_pipeline_batch(
        n, ptrs, lens.ctypes.data_as(i64p), resize_short, size,
        tops.ctypes.data_as(i64p), lefts.ctypes.data_as(i64p),
        flips_arr.ctypes.data_as(intp), _f32ptr(out),
        ok.ctypes.data_as(intp))
    return out, ok.astype(bool)


def decode_dims(data: bytes):
    """Header-only (h, w) probe via the native lib; None if undecodable."""
    import ctypes
    lib = get_lib()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    if not lib.decode_image_dims(_u8ptr(buf), len(data),
                                 ctypes.byref(h), ctypes.byref(w)):
        return None
    return int(h.value), int(w.value)
