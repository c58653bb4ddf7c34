"""ctypes bindings for the C++ host runtime (native/libraytpu_host.so).

Counterpart of raytracer_tpu/utils/native.py.  native/src/host.cpp holds
the host side of an epoch's output: sRGB u8 encoding, the atomic PNG
writer and the tone normaliser's luma percentile (`make -C native` builds
it; git does not track the build).  Each entry has a pure-Python
counterpart (utils/color.py, utils/png.py), which is what runs when no
library loads with all three entries or RAYTPU_NO_NATIVE is set.  Host
code: no device behind it.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_NAME = "libraytpu_host.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
# where the library is looked for, in order: the repo's native/ build, then
# beside this module
CANDIDATES = (os.path.join(_HERE, "..", "..", "native", _NAME), os.path.join(_HERE, _NAME))

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def library():
    """The bound library: the first of CANDIDATES that loads and has the
    three entries, or None (none does, or RAYTPU_NO_NATIVE is set)."""
    if os.environ.get("RAYTPU_NO_NATIVE"):
        return None
    for path in CANDIDATES:
        path = os.path.abspath(path)
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.rt_srgb_encode_u8.argtypes = [_F32P, _U8P, ctypes.c_size_t]
            lib.rt_srgb_encode_u8.restype = None
            lib.rt_write_png_atomic.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_uint32,
                                                ctypes.c_uint32]
            lib.rt_write_png_atomic.restype = ctypes.c_int
            lib.rt_luma_percentile.argtypes = [_F32P, ctypes.c_size_t, ctypes.c_float]
            lib.rt_luma_percentile.restype = ctypes.c_float
        except (OSError, AttributeError):  # not a library, or one without an entry
            continue
        return lib
    return None


def available() -> bool:
    return library() is not None


def srgb_encode_u8(linear: np.ndarray) -> np.ndarray:
    """Linear f32 [..., 3] -> sRGB u8 (utils/color.linear_to_u8)."""
    linear = np.ascontiguousarray(linear, dtype=np.float32)
    out = np.empty(linear.shape, dtype=np.uint8)
    library().rt_srgb_encode_u8(linear.ctypes.data_as(_F32P), out.ctypes.data_as(_U8P),
                                linear.size)
    return out


def write_png_atomic(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] u8 -> a PNG at `path`, through a tmp file and a rename."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rc = library().rt_write_png_atomic(os.fsencode(path), rgb.ctypes.data_as(_U8P), w, h)
    if rc != 0:
        raise OSError(f"native PNG write failed (rc={rc}) for {path}")


def luma_percentile(rgb_flat: np.ndarray, q: float) -> float:
    """Percentile q of per-pixel luma over the pixels whose luma is a
    normal f32, as the reference's tone normaliser takes it
    (src/main.rs:748-762)."""
    rgb_flat = np.ascontiguousarray(rgb_flat, dtype=np.float32)
    return float(library().rt_luma_percentile(rgb_flat.ctypes.data_as(_F32P),
                                              rgb_flat.size // 3, q))
