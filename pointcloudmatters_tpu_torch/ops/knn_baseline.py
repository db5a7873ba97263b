"""Wrapper of the dense-scan kNN CUDA kernel (``csrc/knn_baseline.cu``),
kernel 13 of the port.

Port of ``pointcloudmatters_tpu/ops/pallas_knn.py``; the kernel's design
notes are in its source. The plain PyTorch version, which follows the same
traversal, is ``ops.pointops.knn_query_baseline_plain``; the result does not
depend on the lane group or the query tile.

Each query is a group of S lanes (:func:`choose_group`) and each tile TQ
queries (:func:`choose_tile`): kernel 12's rule with this kernel's
constants, which ``scripts/knn_group_sweep.py`` picked (PERF.md): 16 warps an
SM, lists as short as 32 lanes make them (one slot a lane up to k = 32), TQ
* S = 256.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import knn as _knn
from pointcloudmatters_tpu_torch.ops.knn import check_knn_args

__all__ = ["knn_query_baseline_cuda", "choose_group", "choose_tile", "launch_shape",
           "chunk_points", "MAX_TILE", "MAX_THREADS", "WARPS_PER_SM", "TILE_THREADS",
           "LAUNCHES"]

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0
MAX_TILE = 128  # queries a tile, at most: the TPU's (csrc/knn_baseline.cu kMaxTile)
MAX_THREADS = 256  # TQ * S, at most (kMaxThreads)
# the group rule's constants (scripts/knn_group_sweep.py, PERF.md)
WARPS_PER_SM = 16
TILE_THREADS = 256  # TQ * S: a tile's block is 8 warps


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_baseline")
    if lib.pcm_knn_baseline.argtypes is None:
        lib.pcm_knn_baseline.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.pcm_knn_baseline.restype = ctypes.c_int
        for fn in (lib.pcm_knn_baseline_max_tile, lib.pcm_knn_baseline_max_threads):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.pcm_knn_baseline_max_tile(), lib.pcm_knn_baseline_max_threads()) != (
                MAX_TILE, MAX_THREADS):
            raise RuntimeError("csrc/knn_baseline.cu and ops/knn_baseline.py disagree on "
                               "the tile or the threads")
    return lib


def chunk_points(N: int) -> int:
    """tn, the points a chunk: the TPU's min(2048, max(N, 128))."""
    return min(2048, max(N, 128))


def choose_group(B: int, M: int, k: int, sm_count: int) -> int:
    """S for B clouds of M queries and k results on ``sm_count`` SMs:
    ``ops.knn.choose_group`` with WARPS_PER_SM warps an SM, among the group
    sizes whose lists take no more slots a lane than groups of 32 lanes do
    (k = 16: S >= 16; k = 128: S = 32)."""
    return _knn.choose_group(B, M, k, sm_count, WARPS_PER_SM, _knn.list_rows(k, 32))


def choose_tile(S: int) -> int:
    """TQ, the queries a tile, for groups of S lanes: TILE_THREADS / S, at
    most MAX_TILE (a power of two, TQ * S within the kernel's 32 ..
    MAX_THREADS)."""
    TQ = min(MAX_TILE, max(1, TILE_THREADS // S))
    if not 32 <= TQ * S <= MAX_THREADS:
        raise ValueError(f"dense-scan kNN kernel: no query tile for S={S}")
    return TQ


def launch_shape(B: int, M: int, k: int, device: int) -> tuple[int, int]:
    """(S, TQ) of the kernel for B clouds of M queries, k results, on CUDA
    device ``device``."""
    S = choose_group(B, M, k, _knn.sm_count(device))
    return S, choose_tile(S)


def knn_query_baseline_cuda(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M, 3) queries, (B, N, 3) points, (B, N) bool on a CUDA device ->
    idx (B, M, nsample) int32, d2 (B, M, nsample) f32; 1 <= nsample <= 128."""
    global LAUNCHES
    check_knn_args("dense-scan kNN", new_xyz, xyz, mask, nsample)
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = new_xyz.device
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, M, nsample), dtype=torch.float32, device=dev)
    if B and M:
        S, TQ = launch_shape(B, M, nsample, dev.index)
        rec = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().pcm_knn_baseline(
            new_xyz.data_ptr(), xyz.data_ptr(), mask.data_ptr(), rec.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), B, M, N, nsample, S, TQ, dev.index, stream)
        _build.check(err, "knn_baseline")
        LAUNCHES += 1
    return idx, d2
