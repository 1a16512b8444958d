"""Build and load the port's CUDA kernels (``light_whisper_tpu_torch/csrc/*.cu``).

At first use, every source compiles with its own ``nvcc``, all started at
once, and the objects link into one shared library with a plain C interface,
which is loaded with ``ctypes``. PyTorch's own extension
builder is not used: a source that includes PyTorch's headers takes minutes
to compile, a plain C interface seconds. Pointers and the CUDA stream are
passed as ``c_void_p``, integers as ``c_int``.

The library lands in ``build/lwt_torch_kernels/<hash of the sources and
flags>/``, so an edited source rebuilds and an unchanged one is reused.
Nothing is built at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lwt_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    try:
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{build_log}")
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
            lib.lwt_q8_tile_plan.argtypes = [ci, ci] + [ctypes.POINTER(ci)] * 3
            lib.lwt_q8_tile_plan.restype = ci
            lib.lwt_q8_matmul_tile.argtypes = [vp] * 4 + [ci] * 5 + [vp]
            lib.lwt_q8_matmul_tile.restype = ci
            lib.lwt_decode_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, vp]
            lib.lwt_decode_attention.restype = ci
            lib.lwt_decode_attention_batched.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, vp]
            lib.lwt_decode_attention_batched.restype = ci
            lib.lwt_decode_attention_clusters.argtypes = [ci, ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
            lib.lwt_decode_attention_clusters.restype = ci
            lib.lwt_flash_prefill.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
            lib.lwt_flash_prefill.restype = ci
            lib.lwt_flash_prefill_plan.argtypes = [ci] * 5 + [ctypes.POINTER(ci)] * 2
            lib.lwt_flash_prefill_plan.restype = ci
            lib.lwt_fused_ffn_step.argtypes = [vp] * 9 + [ci, ci, ci, cf, vp]
            lib.lwt_fused_ffn_step.restype = ci
            lib.lwt_fused_gateup_silu.argtypes = [vp] * 4 + [ci, ci, ci, vp]
            lib.lwt_fused_gateup_silu.restype = ci
            lib.lwt_q8_probe.argtypes = [ci] + [vp] * 4 + [ci, ci, ci, ci, cf, vp]
            lib.lwt_q8_probe.restype = ci
            lib.lwt_q8_matmul_perm.argtypes = [vp] * 4 + [ci, ci, ci, ci, vp]
            lib.lwt_q8_matmul_perm.restype = ci
            _lib = lib
        return _lib


_tally = threading.local()


def count_launch(counters: Dict[str, int], key: str) -> None:
    """Count one launch in an op module's ``LAUNCHES``; inside
    :func:`launch_tally` on this thread, note it there too."""
    counters[key] += 1
    notes = getattr(_tally, "notes", None)
    if notes is not None:
        notes.append((counters, key))


@contextlib.contextmanager
def launch_tally() -> Iterator[List[Tuple[Dict[str, int], str]]]:
    """The ``(counters, key)`` of every launch this thread counts inside the
    block (a CUDA graph capture counts launches it only records)."""
    previous = getattr(_tally, "notes", None)
    _tally.notes = notes = []
    try:
        yield notes
    finally:
        _tally.notes = previous


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
