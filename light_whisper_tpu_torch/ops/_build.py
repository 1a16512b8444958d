"""Build and load the port's CUDA kernels (``light_whisper_tpu_torch/csrc/*.cu``).

All sources compile, at first use, with ``nvcc`` into one shared library with
a plain C interface, which is loaded with ``ctypes``. PyTorch's own extension
builder is not used: a source that includes PyTorch's headers takes minutes
to compile, a plain C interface seconds. Pointers and the CUDA stream are
passed as ``c_void_p``, integers as ``c_int``.

The library lands in ``build/lwt_torch_kernels/<hash of the sources and
flags>/``, so an edited source rebuilds and an unchanged one is reused.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lwt_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIB_NAME = "liblwt_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build printed (the ptxas register / shared-memory report).
build_log = ""


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact source set has no library yet."""
    global build_log
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees a partial file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.lwt_q8_matmul.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, vp]
            lib.lwt_q8_matmul.restype = ci
            lib.lwt_decode_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
            lib.lwt_decode_attention.restype = ci
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
