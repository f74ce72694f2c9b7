"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles each source for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``_build/`` (git-ignored) under a name keyed on a
hash of the source and the flags, so a stale library is never loaded. A
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

TILE = 4096     # elements per block of the segscan kernels (csrc/segscan.cu)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet); return the .so path."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def segscan_lib() -> ctypes.CDLL:
    """The segscan kernels K1/K2 (built on first call)."""
    lib = ctypes.CDLL(build("segscan"))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.km_segscan_bwd.restype = i
    lib.km_segscan_bwd.argtypes = [p, p, p, p, p, i64, i, p, p, p, p, p, p]
    lib.km_segscan_fwd.restype = i
    lib.km_segscan_fwd.argtypes = [p, p, p, p, p, p, i64, i, i, p, p, p, p,
                                   p, p]
    lib.km_segscan_tile.restype = i
    lib.km_segscan_tile.argtypes = []
    lib.km_error_string.restype = ctypes.c_char_p
    lib.km_error_string.argtypes = [i]
    if lib.km_segscan_tile() != TILE:
        raise RuntimeError("csrc/segscan.cu TILE differs from _build.TILE")
    return lib


@functools.cache
def merge_runs_lib() -> ctypes.CDLL:
    """The merge-path run merge K3/K4 (built on first call)."""
    lib = ctypes.CDLL(build("merge_runs"))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.km_merge_runs.restype = i
    lib.km_merge_runs.argtypes = [i, p, p, p, i64, p, p, p, i64, p, p, p, p]
    lib.km_error_string.restype = ctypes.c_char_p
    lib.km_error_string.argtypes = [i]
    return lib
