"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/`` next to
this file at first use and loaded with :mod:`ctypes`. A library's file name
carries a hash of its source, of the shared headers (``csrc/*.cuh``) and of
the flags, so an edited kernel is rebuilt and a stale one is never loaded.
The sources include no PyTorch header, which keeps a build to seconds;
tensors cross the boundary as raw pointers and the stream as a
``cudaStream_t`` handle (see the wrappers in ``ops/``).

Every C entry point returns the ``cudaError_t`` of its launch, and
:func:`check` turns a non-zero one into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "check"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("fps", "knn", "knn_chunkskip", "knn_baseline", "attention_fwd", "attention_bwd",
           "fused_builder", "fused_mha", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
            "kernels of pointcloudmatters_tpu_torch need the CUDA toolkit"
        )
    return path


def _library(name: str) -> tuple[str, str]:
    """(source, library) paths of kernel ``name``."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all at once.

    Returns the compiler's output (``-Xptxas=-v``: registers, shared memory
    and spills of each kernel) by name, for the libraries it compiled.
    Raises ``RuntimeError`` with that output if ``nvcc`` fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _library(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, lib, tmp, proc in jobs:
        logs[name] = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(_library(name)[1])
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
