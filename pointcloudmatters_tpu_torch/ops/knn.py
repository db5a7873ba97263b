"""Wrapper of the exact kNN CUDA kernel (``csrc/knn.cu``), the lane-group
chooser that kernels 2 and 12 share, and the argument checks that the three
kNN kernels' wrappers share.

Port of ``pointcloudmatters_tpu/ops/pallas_knn3.py``; the kernel's design
notes are in its source and in ``csrc/knn_select.cuh``. The plain PyTorch
version with the same semantics is ``ops.pointops.knn_query_padded_plain``.

The kernel serves a query by a group of S lanes of one warp; S is chosen
here (:func:`choose_group`), so that the CPU tests can check the rule.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = ["knn_query_padded_cuda", "check_knn_args", "choose_group", "list_rows",
           "launch_group", "order_multiplier", "sm_count", "MAX_K", "MAX_ROWS",
           "GROUP_SIZES", "THREADS", "WARPS_PER_SM", "LAUNCHES"]

# the largest k the kNN kernels take (csrc/knn_topk.cuh kMaxK, the TPU
# kernels' 128)
MAX_K = 128
# list slots a lane holds at most (csrc/knn_select.cuh kMaxRows)
MAX_ROWS = 16
# the lane-group sizes the kernels take
GROUP_SIZES = (1, 2, 4, 8, 16, 32)
THREADS = 256  # threads a block of kernel 2 (csrc/knn.cu kThreads)
# the warps a group size has to give each SM before a smaller one is taken
WARPS_PER_SM = 8
# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    if lib.pcm_knn.argtypes is None:
        lib.pcm_knn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.pcm_knn.restype = ctypes.c_int
        for fn in (lib.pcm_knn_max_k, lib.pcm_knn_max_rows, lib.pcm_knn_threads):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.pcm_knn_order_multiplier.argtypes = [ctypes.c_int]
        lib.pcm_knn_order_multiplier.restype = ctypes.c_int
        if (lib.pcm_knn_max_k(), lib.pcm_knn_max_rows(), lib.pcm_knn_threads()) != (
                MAX_K, MAX_ROWS, THREADS):
            raise RuntimeError("csrc/knn.cu and ops/knn.py disagree on k, rows or threads")
    return lib


def list_rows(k: int, S: int) -> int:
    """List slots a lane holds for k results in groups of S lanes: the least
    power of two at or above k, spread over S lanes, at least one a lane."""
    K = 1 << (k - 1).bit_length()
    return max(1, K // S)


def order_multiplier(N: int) -> int:
    """A, the kernel's visiting order (position j holds point j A mod N):
    the odd number nearest N (sqrt(5) - 1) / 2 that is coprime to N, 1 for
    N <= 2 (csrc/knn.cu ``order_multiplier``)."""
    a = int(N * 0.6180339887498949) | 1
    while a > 1 and math.gcd(a, N) != 1:
        a += 2
    return a if a < N else 1


def choose_group(B: int, M: int, k: int, sm_count: int, warps_per_sm: int = WARPS_PER_SM,
                 max_rows: int = MAX_ROWS) -> int:
    """S, the lanes a query, for B clouds of M queries and k results on a
    device of ``sm_count`` SMs: the smallest group size whose B * M * S / 32
    warps give each SM ``warps_per_sm`` warps, among those whose lists fit
    ``max_rows`` slots a lane (MAX_ROWS, the kernels' limit: k = 32 takes S
    >= 2, k = 64 S >= 4, k = 128 S >= 8); the largest of those if none
    does."""
    fits = [S for S in GROUP_SIZES if list_rows(k, S) <= max_rows]
    for S in fits:
        if B * M * S >= 32 * warps_per_sm * sm_count:
            return S
    return fits[-1]


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_group(B: int, M: int, k: int, device: int) -> int:
    """S of the kNN kernels for B clouds of M queries, k results, on CUDA
    device ``device``."""
    return choose_group(B, M, k, sm_count(device))


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
    S = launch_group(B, M, nsample, dev.index)
    # the points' records and their indices, in the kernel's visiting order
    rec = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
    rec_idx = torch.empty((B, N), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().pcm_knn(new_xyz.data_ptr(), xyz.data_ptr(), mask.data_ptr(), rec.data_ptr(),
                         rec_idx.data_ptr(), idx.data_ptr(), d2.data_ptr(), B, M, N, nsample,
                         S, dev.index, stream)
    _build.check(err, "knn")
    LAUNCHES += 1
    return idx, d2
