"""Native (C++) decoders, loaded via ctypes.

The reference links vendored C coders directly (coders/rangecoder/*); this
copy compiles its own translation units into one shared object at first
use (g++ is in the image, pybind11 is not — hence ctypes): the range and
context range decoders, the rANS decoder and the PE pair-order walk.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from ..utils.errors import PgtcFormatError

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libpgrc_native.so")
_SOURCES = [os.path.join(_HERE, "rangecoder.cpp"),
            os.path.join(_HERE, "rans.cpp"),
            os.path.join(_HERE, "pairwalk.cpp")]

_lock = threading.Lock()
_lib_handle = None
_lib_failed = False


def _build() -> bool:
    srcs_mtime = max(os.path.getmtime(s) for s in _SOURCES)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= srcs_mtime:
        return True
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-o", _SO + ".tmp", *_SOURCES],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(_SO + ".tmp", _SO)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded shared object, or None when it does not build or load."""
    global _lib_handle, _lib_failed
    if _lib_handle is not None or _lib_failed:
        return _lib_handle
    with _lock:
        if _lib_handle is not None or _lib_failed:
            return _lib_handle
        if not _build():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _lib_failed = True
            return None
        lib.rc_decode.restype = ctypes.c_int64
        lib.rc_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.rcx_decode.restype = ctypes.c_int64
        lib.rcx_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.rans_decode.restype = ctypes.c_int64
        lib.rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.pair_walk_decode.restype = ctypes.c_int32
        lib.pair_walk_decode.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib_handle = lib
    return _lib_handle


def _need():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the decoder's native library did not build")
    return lib


def rc_decode(data: bytes, count: int, order: int, period: int, nsym: int) -> bytes:
    out = ctypes.create_string_buffer(count if count else 1)
    n = _need().rc_decode(data, len(data), count, order, period, nsym, out)
    if n != count:
        raise PgtcFormatError("malformed range-coded stream")
    return out.raw[:count]


def rcx_decode(data: bytes, count: int, nsym: int, order: int) -> bytes:
    out = ctypes.create_string_buffer(count if count else 1)
    n = _need().rcx_decode(data, len(data), count, nsym, order, out)
    if n != count:
        raise PgtcFormatError("malformed context range-coded stream")
    return out.raw[:count]


def rans_decode(data: bytes, count: int) -> bytes:
    out = ctypes.create_string_buffer(max(count, 1))
    n = _need().rans_decode(data, len(data), count, out)
    if n < 0:
        raise PgtcFormatError("malformed rANS stream")
    return out.raw[:count]


def pair_walk_decode(offs):
    """offs: int64 numpy array of per-pair offsets -> int64 order array
    [2*n_pairs], or None when the offsets are malformed."""
    import numpy as np

    offs = np.ascontiguousarray(offs, dtype=np.int64)
    out = np.empty(offs.size * 2, dtype=np.int64)
    rc = _need().pair_walk_decode(
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out
