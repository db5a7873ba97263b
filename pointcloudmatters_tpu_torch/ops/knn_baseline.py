"""Wrapper of the dense-scan kNN CUDA kernel (``csrc/knn_baseline.cu``),
kernel 13 of the port.

Port of ``pointcloudmatters_tpu/ops/pallas_knn.py``; the kernel's design
notes are in its source. The plain PyTorch version, which follows the same
traversal, is ``ops.pointops.knn_query_baseline_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops.knn import check_knn_args

__all__ = ["knn_query_baseline_cuda", "LAUNCHES"]

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_baseline")
    if lib.pcm_knn_baseline.argtypes is None:
        lib.pcm_knn_baseline.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.pcm_knn_baseline.restype = ctypes.c_int
    return lib


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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().pcm_knn_baseline(
            new_xyz.data_ptr(), xyz.data_ptr(), mask.data_ptr(), idx.data_ptr(),
            d2.data_ptr(), B, M, N, nsample, dev.index, stream)
        _build.check(err, "knn_baseline")
        LAUNCHES += 1
    return idx, d2
