"""Wrapper of the chunk-skipping kNN CUDA kernel (``csrc/knn_chunkskip.cu``),
kernel 12 of the port, and its query-tile chooser.

Port of ``pointcloudmatters_tpu/ops/pallas_knn2.py``; the kernel's design
notes are in its source. The plain PyTorch version, which follows the same
traversal at the same query tile, is
``ops.pointops.knn_query_chunkskip_plain(..., tm=TQ)``. The kernel is exact
on any query order; ``ops.pointops.knn_query_padded`` sorts the queries
along a Morton curve first, so that chunks skip.

Each query is a group of S lanes (:func:`choose_group`, kernel 2's rule
with this kernel's constants), each tile TQ queries (:func:`choose_tile`).
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import knn as _knn
from pointcloudmatters_tpu_torch.ops.knn import check_knn_args

__all__ = ["knn_query_chunkskip_cuda", "choose_group", "choose_tile", "launch_shape",
           "chunk_points", "MAX_TILE", "MAX_THREADS", "WARPS_PER_SM", "MAX_FAST_ROWS",
           "TILE_THREADS", "LAUNCHES"]

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0
MAX_TILE = 128  # queries a tile, at most: the TPU's (csrc/knn_chunkskip.cu kMaxTile)
MAX_THREADS = 256  # TQ * S, at most (kMaxThreads)
BOX_FLOATS = 8  # a chunk's box (csrc/knn_select.cuh kBoxFloats)
# the group rule's constants (scripts/knn_group_sweep.py, PERF.md): twice
# kernel 2's warps an SM, and lists of at most 2 slots a lane where k allows
WARPS_PER_SM = 16
MAX_FAST_ROWS = 2
TILE_THREADS = 128  # TQ * S: a tile's block is 4 warps


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_chunkskip")
    if lib.pcm_knn_chunkskip.argtypes is None:
        lib.pcm_knn_chunkskip.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.pcm_knn_chunkskip.restype = ctypes.c_int
        for fn in (lib.pcm_knn_chunkskip_max_tile, lib.pcm_knn_chunkskip_max_threads,
                   lib.pcm_knn_chunkskip_box_floats):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.pcm_knn_chunkskip_max_tile(), lib.pcm_knn_chunkskip_max_threads(),
                lib.pcm_knn_chunkskip_box_floats()) != (MAX_TILE, MAX_THREADS, BOX_FLOATS):
            raise RuntimeError("csrc/knn_chunkskip.cu and ops/knn_chunkskip.py disagree on "
                               "the tile, the threads or the box")
    return lib


def chunk_points(N: int) -> int:
    """tn, the points a chunk: the TPU's min(512, max(N, 128))."""
    return min(512, max(N, 128))


def choose_group(B: int, M: int, k: int, sm_count: int) -> int:
    """S for B clouds of M queries and k results on ``sm_count`` SMs:
    ``ops.knn.choose_group`` with WARPS_PER_SM warps an SM, among the group
    sizes whose lists take at most MAX_FAST_ROWS slots a lane (k = 16: S >=
    8), or the kernels' MAX_ROWS where none does (k > 64)."""
    rows = MAX_FAST_ROWS if _knn.list_rows(k, 32) <= MAX_FAST_ROWS else _knn.MAX_ROWS
    return _knn.choose_group(B, M, k, sm_count, WARPS_PER_SM, rows)


def choose_tile(S: int) -> int:
    """TQ, the queries a tile, for groups of S lanes: TILE_THREADS / S, so
    that every block is 4 warps and the blocks fill the card as S's warps
    do (a power of two, 1 <= TQ <= MAX_TILE, TQ * S within the kernel's
    32 .. MAX_THREADS)."""
    TQ = min(MAX_TILE, max(1, TILE_THREADS // S))
    if not 32 <= TQ * S <= MAX_THREADS:
        raise ValueError(f"chunk-skip kNN kernel: no query tile for S={S}")
    return TQ


def launch_shape(B: int, M: int, k: int, device: int) -> tuple[int, int]:
    """(S, TQ) of the kernel for B clouds of M queries, k results, on CUDA
    device ``device``."""
    S = choose_group(B, M, k, _knn.sm_count(device))
    return S, choose_tile(S)


def knn_query_chunkskip_cuda(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int,
    with_skipped: bool = False, with_pruned: bool = False,
):
    """(B, M, 3) queries, (B, N, 3) points, (B, N) bool on a CUDA device ->
    idx (B, M, nsample) int32, d2 (B, M, nsample) f32; 1 <= nsample <= 128.
    With ``with_skipped`` also a 0-d int32 device tensor: the (query tile,
    chunk) pairs that the launch skipped, of ``B * ceil(M / TQ) * ceil(N /
    min(512, max(N, 128)))``, TQ = ``launch_shape(...)[1]``; with
    ``with_pruned`` then also those of them it skipped by their boxes,
    without a distance."""
    global LAUNCHES
    check_knn_args("chunk-skip kNN", new_xyz, xyz, mask, nsample)
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = new_xyz.device
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, M, nsample), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev) if with_skipped else None
    if B and M:
        S, TQ = launch_shape(B, M, nsample, dev.index)
        rec = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
        boxes = torch.empty((B, -(-N // chunk_points(N)), BOX_FLOATS), dtype=torch.float32,
                            device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().pcm_knn_chunkskip(
            new_xyz.data_ptr(), xyz.data_ptr(), mask.data_ptr(), rec.data_ptr(),
            boxes.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            None if counts is None else counts.data_ptr(), B, M, N, nsample, S, TQ,
            dev.index, stream)
        _build.check(err, "knn_chunkskip")
        LAUNCHES += 1
    if not with_skipped:
        return idx, d2
    return (idx, d2, counts[0], counts[1]) if with_pruned else (idx, d2, counts[0])
