"""Wrapper of the exact kNN CUDA kernel (``csrc/knn.cu``), and the argument
checks that the three kNN kernels' wrappers share.

Port of ``pointcloudmatters_tpu/ops/pallas_knn3.py``; the kernel's design
notes are in its source. The plain PyTorch version with the same semantics
is ``ops.pointops.knn_query_padded_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = ["knn_query_padded_cuda", "check_knn_args", "MAX_K", "LAUNCHES"]

# the largest k the kNN kernels take (csrc/knn_topk.cuh kMaxK, the TPU
# kernels' 128)
MAX_K = 128
# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    if lib.pcm_knn.argtypes is None:
        lib.pcm_knn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.pcm_knn.restype = ctypes.c_int
    return lib


def check_knn_args(what: str, new_xyz: torch.Tensor, xyz: torch.Tensor,
                   mask: torch.Tensor, nsample: int) -> None:
    """Raise unless the inputs are what a kNN kernel takes: (B, M, 3) and
    (B, N, 3) f32, a (B, N) bool mask, contiguous on one CUDA device, N >= 1
    and 1 <= nsample <= MAX_K."""
    dev = new_xyz.device
    if not new_xyz.is_cuda or xyz.device != dev or mask.device != dev:
        raise ValueError(
            f"{what} kernel needs its inputs on one CUDA device, got {dev}, "
            f"{xyz.device} and {mask.device}"
        )
    if (new_xyz.dtype != torch.float32 or xyz.dtype != torch.float32
            or mask.dtype != torch.bool):
        raise TypeError(f"{what} kernel takes f32 coordinates and a bool mask, "
                        f"got {new_xyz.dtype}, {xyz.dtype} and {mask.dtype}")
    if (new_xyz.ndim != 3 or xyz.ndim != 3 or new_xyz.shape[-1] != 3
            or xyz.shape[-1] != 3 or new_xyz.shape[0] != xyz.shape[0]
            or mask.shape != xyz.shape[:2]):
        raise ValueError(
            f"{what} kernel shapes: new_xyz {tuple(new_xyz.shape)}, xyz "
            f"{tuple(xyz.shape)}, mask {tuple(mask.shape)}; want (B, M, 3), "
            f"(B, N, 3) and (B, N)"
        )
    if not (new_xyz.is_contiguous() and xyz.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous inputs")
    if not 1 <= nsample <= MAX_K or xyz.shape[1] < 1:
        raise ValueError(f"{what} kernel takes 1 <= nsample <= {MAX_K} and N >= 1, "
                         f"got nsample={nsample}, N={xyz.shape[1]}")


def knn_query_padded_cuda(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M, 3) queries, (B, N, 3) points, (B, N) bool on a CUDA device ->
    idx (B, M, nsample) int32, d2 (B, M, nsample) f32; 1 <= nsample <= 128."""
    global LAUNCHES
    check_knn_args("kNN", new_xyz, xyz, mask, nsample)
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = new_xyz.device
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
    d2 = torch.empty((B, M, nsample), dtype=torch.float32, device=dev)
    if B == 0 or M == 0:
        return idx, d2
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().pcm_knn(new_xyz.data_ptr(), xyz.data_ptr(), mask.data_ptr(),
                         idx.data_ptr(), d2.data_ptr(), B, M, N, nsample,
                         dev.index, stream)
    _build.check(err, "knn")
    LAUNCHES += 1
    return idx, d2
