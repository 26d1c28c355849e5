"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (named by a hash of the source and flags, so an edited source
rebuilds) and loaded with ``ctypes``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register/spill report) and seconds per built library
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, src, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def join_lib() -> ctypes.CDLL:
    """The join kernel's library (``csrc/join.cu``), built on first use."""
    lib = _libs.get("join")
    if lib is None:
        lib = ctypes.CDLL(build("join"))
        p = ctypes.c_void_p
        # sigma, decode, tbl, n_rows, key, payload, seg_base, seg_shift,
        # rank, sym, n, stream
        lib.sview_join.argtypes = [ctypes.c_int, ctypes.c_int, p, ctypes.c_int64,
                                   p, p, p, ctypes.c_int, p, p, ctypes.c_int64, p]
        lib.sview_join.restype = ctypes.c_int
        lib.sview_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sview_cuda_error_string.restype = ctypes.c_char_p
        _libs["join"] = lib
    return lib


def gather_search_lib() -> ctypes.CDLL:
    """The gather engine's search kernel (``csrc/gather_search.cu``), built
    on first use."""
    lib = _libs.get("gather_search")
    if lib is None:
        lib = ctypes.CDLL(build("gather_search"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # planes, lanes, sigma, fused, row_words, kmer_tbl, n_kmer, dense_lo,
        # dense_hi, dense_k, kmer_size, count_arr, sentinel, sym, lens, B, L,
        # steps, lo, hi, stream
        lib.sview_gather_search.argtypes = [i32, i32, i32, p, i64, p, i64, p, p, i32, i32,
                                            p, i64, p, p, i64, i64, i64, p, p, p]
        lib.sview_gather_search.restype = ctypes.c_int
        _libs["gather_search"] = lib
    return lib


def lf_walk_lib() -> ctypes.CDLL:
    """The LF walk's kernel (``csrc/lf_walk.cu``), built on first use."""
    lib = _libs.get("lf_walk")
    if lib is None:
        lib = ctypes.CDLL(build("lf_walk"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # planes, lanes, sigma, fused, row_words, count_arr, n_count, sa,
        # sentinel, r, rows, valid, n, out, stats, stream
        lib.sview_lf_walk.argtypes = [i32, i32, i32, p, i64, p, i64, p, i64, i64, p, p, i64,
                                      p, p, p]
        lib.sview_lf_walk.restype = ctypes.c_int
        _libs["lf_walk"] = lib
    return lib


def cuda_error(err: int) -> str:
    msg = join_lib().sview_cuda_error_string(err)
    return f"CUDA error {err} ({msg.decode() if msg else 'unknown'})"
