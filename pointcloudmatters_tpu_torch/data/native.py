"""ctypes bindings of the host data path's native kernels (port of
``pointcloudmatters_tpu/data/native.py``).

``native/pcm_native.cpp`` (FNV hash, radix argsort, voxel segments and the
one-random-point-per-voxel pick of ``GridSamplePCD``'s train mode) is built
by ``g++`` at first use into ``build/`` next to this package, under a name
that carries a hash of the source, the flags and this CPU's model and
feature flags (``-march=native`` builds for this CPU alone), and loaded from
there. The library tracked beside the source is never loaded: it was built
on another CPU and may fault on this one. Without a
compiler, or when the build fails, every function returns ``None`` and the
callers take their numpy route (:func:`route` says which one runs).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["available", "route", "fnv_hash", "grid_subsample_train", "grid_segments"]

log = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "pcm_native.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _cpu() -> bytes:
    """The CPU's model name and feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"\n".join([line for line in f.read().splitlines()
                               if line.startswith((b"model name", b"flags"))][:2])
    except OSError:
        return platform.processor().encode()


def _library() -> str:
    digest = hashlib.sha256()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu())
    return os.path.join(BUILD_DIR, f"pcm_native-{digest.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        log.info(f"native build unavailable ({e}); using the numpy data path")
        return False
    os.replace(tmp, lib)  # atomic: another process never loads half a file
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        lib_path = _library()
        if not os.path.exists(lib_path) and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as e:
            log.info(f"native library failed to load ({e}); using the numpy data path")
            return None
        lib.pcm_fnv_hash.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64, _U64P]
        lib.pcm_fnv_hash.restype = None
        lib.pcm_grid_subsample_train.argtypes = [
            _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _I64P]
        lib.pcm_grid_subsample_train.restype = ctypes.c_int64
        lib.pcm_grid_segments.argtypes = [
            _I64P, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I64P]
        lib.pcm_grid_segments.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return get_lib() is not None


def route() -> str:
    """``"native"`` or ``"numpy"``: the route of train-mode grid sampling."""
    return "numpy" if get_lib() is None else "native"


def fnv_hash(coords: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, np.int64)
    out = np.empty(coords.shape[0], np.uint64)
    lib.pcm_fnv_hash(coords, coords.shape[0], coords.shape[1], out)
    return out


def grid_subsample_train(grid_coord: np.ndarray,
                         seed: Optional[int] = None) -> Optional[np.ndarray]:
    """One fused pass: hash, sort, segment and a random pick a voxel.
    Returns the picked points' indices (n_voxels,), or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    coords = np.ascontiguousarray(grid_coord, np.int64)
    idx = np.empty(coords.shape[0], np.int64)
    if seed is None:
        seed = int(np.random.randint(0, 2**63 - 1))
    n = lib.pcm_grid_subsample_train(
        coords, coords.shape[0], coords.shape[1], ctypes.c_uint64(seed), idx)
    return idx[:n]


def grid_segments(grid_coord: np.ndarray):
    """(order, starts, counts) over the hash-sorted voxels, or None."""
    lib = get_lib()
    if lib is None:
        return None
    coords = np.ascontiguousarray(grid_coord, np.int64)
    n = coords.shape[0]
    order = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    n_vox = lib.pcm_grid_segments(coords, n, coords.shape[1], order, starts, counts)
    return order, starts[:n_vox], counts[:n_vox]
