"""ctypes loader for the native C++ SA-IS extension.

The shared library is built from ``sais.cpp`` by ``build_native.py`` into the
package's ``_build/`` directory at first use.  This is the analog of the reference's
optional libdivsufsort FFI backend
(``src/components/suffix_array/burrow_wheeler_transform/libdivsufsort/mod.rs``).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import build_native

_lock = threading.Lock()
_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib_path = build_native.output_path()
        if not os.path.exists(lib_path):
            if os.environ.get("SVIEW_FMINDEX_NO_AUTOBUILD"):
                _load_failed = True
                return None
            try:  # build on first use (g++ is a baseline dependency)
                build_native.build(verbose=False)
            except Exception:
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(lib_path)
            lib.sview_sais_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            lib.sview_sais_u8.restype = ctypes.c_int32
            lib.sview_sais_u8_i32.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            lib.sview_sais_u8_i32.restype = ctypes.c_int32
            _lib = lib
        except OSError:
            _load_failed = True
            return None
    return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(s: np.ndarray) -> np.ndarray:
    """SA-IS over uint8 array ``s`` (sentinel-terminated).

    Returns int32 SA for n < 2^31 (the Gbp-scale memory-lean path), int64
    beyond.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native SA-IS library not built; run python -m sview_fmindex_tpu_torch.native.build_native"
        )
    assert s.dtype == np.uint8 and s.flags.c_contiguous
    n = len(s)
    if n < 2**31:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.sview_sais_u8_i32(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n),
        )
    else:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sview_sais_u8(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
        )
    if rc != 0:
        raise RuntimeError(f"native SA-IS failed with code {rc}")
    return sa
