"""Build the native C++ extension: ``python -m sview_fmindex_tpu_torch.native.build_native``.

The shared library goes to the package's ``_build/`` directory (beside the
CUDA kernels' libraries), named by a hash of the source and the compiler
flags, so an edited source rebuilds and nothing is written among the sources.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
SOURCES = ["sais.cpp"]
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def output_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in SOURCES:
        with open(os.path.join(HERE, s), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsview_native_{h.hexdigest()[:16]}.so")


def build(verbose: bool = True) -> str:
    out = output_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # atomic publish: concurrent first uses must never load a half-written library
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(HERE, s) for s in SOURCES), "-o", tmp]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    print(build())
