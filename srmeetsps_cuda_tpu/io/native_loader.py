"""Bridge to the native C++ PNG decoder (native/pngio.cpp).

The reference's data-ingestion layer is native (OpenCV imgcodecs + matio);
this build keeps an optional native fast path for the hot part — PNG
decode of n high-res frames — as a small libpng-based shared library driven
through ctypes. Falls back to the numpy codec (``io/png.py``) when the
library isn't built.

Build: ``make -C native`` (produces ``native/libpngio.so``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _load_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libpngio.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.pngio_read_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),  # width
            ctypes.POINTER(ctypes.c_int),  # height
            ctypes.POINTER(ctypes.c_int),  # channels
            ctypes.POINTER(ctypes.c_int),  # bit depth
        ]
        lib.pngio_read_info.restype = ctypes.c_int
        lib.pngio_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.pngio_decode.restype = ctypes.c_int
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def decode_png(path: str) -> Optional[np.ndarray]:
    """Decode a PNG via the native library. Returns None when the native
    library is unavailable (caller falls back to ``io/png.py``)."""
    lib = _load_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    bd = ctypes.c_int()
    rc = lib.pngio_read_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), ctypes.byref(bd))
    if rc != 0:
        raise IOError(f"pngio: cannot read {path} (rc={rc})")
    dtype = np.uint16 if bd.value == 16 else np.uint8
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, dtype)
    rc = lib.pngio_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"pngio: decode failed for {path} (rc={rc})")
    return out
