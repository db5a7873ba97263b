"""Wrapper of the farthest-point-sampling CUDA kernel (``csrc/fps.cu``).

Port of ``pointcloudmatters_tpu/ops/pallas_fps.py``; the kernel's design
notes are in its source. The plain PyTorch version with the same semantics
is ``ops.pointops.farthest_point_sampling_padded_plain``.

The kernel spreads each cloud over a thread-block cluster of C CTAs; the
cluster size and the threads a CTA are chosen here (:func:`choose_cluster`),
so that the CPU tests can check the rules. Above MAX_RESIDENT points a cloud
each of the 16 CTAs streams the part of its slice beyond MAX_SLICE points
every round, its distances in a scratch tensor made here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = ["farthest_point_sampling_padded_cuda", "choose_cluster", "cta_threads",
           "cluster_slice", "launch_shape", "max_points", "LAUNCHES", "MAX_CLUSTER",
           "MAX_SLICE", "MAX_RESIDENT", "MAX_POINTS_PER_THREAD", "WARPS_PER_SM"]

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0

MAX_CLUSTER = 16  # CTAs a cloud (a non-portable cluster size above 8)
MAX_SLICE = 12288  # points a CTA holds (csrc/fps.cu kMaxSlice: 192 KiB of float4)
MAX_POINTS_PER_THREAD = 12  # csrc/fps.cu kMaxPPT
MAX_THREADS = 1024
# points a cluster holds in shared memory (csrc/fps.cu kMaxResident); a
# larger cloud streams the rest of each slice
MAX_RESIDENT = MAX_CLUSTER * MAX_SLICE
MAX_CTAS_PER_SM = 32  # Hopper's limit of resident blocks an SM
# the warps an SM runs for FPS, shared by the CTAs on it: more shorten a
# round's pass over the points, fewer its reductions
WARPS_PER_SM = 16


def _lib() -> ctypes.CDLL:
    lib = _build.load("fps")
    if lib.pcm_fps.argtypes is None:
        lib.pcm_fps.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.pcm_fps.restype = ctypes.c_int
        lib.pcm_fps_max_active_clusters.argtypes = [ctypes.c_int] * 4
        lib.pcm_fps_max_active_clusters.restype = ctypes.c_int
        for fn in (lib.pcm_fps_max_points, lib.pcm_fps_max_slice,
                   lib.pcm_fps_max_points_per_thread):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.pcm_fps_max_slice(), lib.pcm_fps_max_points_per_thread()) != (
                MAX_SLICE, MAX_POINTS_PER_THREAD):
            raise RuntimeError("csrc/fps.cu and ops/fps.py disagree on the slice limits")
    return lib


def max_points() -> int:
    """The most points a cloud the kernel takes (``pcm_fps_max_points``: an
    index stays below the kernel's 2^31 - 1 "no index")."""
    return _lib().pcm_fps_max_points()


def cluster_slice(N: int, C: int) -> int:
    """Points of the largest slice of a cloud of N points over C CTAs."""
    return -(-N // C)


def cta_threads(slice_points: int, ctas_per_sm: int) -> int:
    """Threads a CTA for a slice when ``ctas_per_sm`` CTAs share an SM:
    WARPS_PER_SM warps an SM between them, but at least 2 and at most
    MAX_POINTS_PER_THREAD points a thread; a multiple of 32, at most 1024."""
    warps = min(max(1, WARPS_PER_SM // ctas_per_sm), -(-slice_points // 64))
    warps = max(warps, -(-slice_points // (32 * MAX_POINTS_PER_THREAD)))
    return min(MAX_THREADS, 32 * warps)


def choose_cluster(B: int, N: int, sm_count: int,
                   active_clusters: Callable[[int, int], int]) -> tuple[int, int]:
    """(C, T): the cluster size and the threads a CTA for B clouds of N
    points on a device with ``sm_count`` SMs, where ``active_clusters(C,
    T)`` is how many clusters of C CTAs of T threads (for these N) it holds
    at once:

    - C is a power of two, at least ceil(N / MAX_SLICE) (a slice fits the
      shared memory and a thread's registers) and at most MAX_CLUSTER;
      above MAX_RESIDENT points C is MAX_CLUSTER and T is MAX_THREADS
      (``cta_threads`` gives it), each CTA streaming the rest of its slice;
    - for each C, T is ``cta_threads`` for k CTAs an SM, k = ceil(B C /
      sm_count) when all B clusters run, or for the least k above that
      with which B clusters fit the device at once (``active_clusters`` >=
      B): alone on an SM a CTA takes more warps to shorten a round, CTAs
      that share one take fewer, whose reductions cost less;
    - C is the largest for which such a T exists, so that no cloud waits
      for another's cluster; at the least C, if none exists, T is that of
      k, and one cluster has to fit.

    Raises ``ValueError`` when not even that fits.
    """
    least = 1
    while least * MAX_SLICE < N and least < MAX_CLUSTER:
        least *= 2
    C = MAX_CLUSTER
    while True:
        S = cluster_slice(N, C)
        k = -(-B * C // sm_count)
        for share in range(k, max(k, MAX_CTAS_PER_SM) + 1):
            T = cta_threads(S, share)
            if active_clusters(C, T) >= B:
                return C, T
            if T == cta_threads(S, MAX_CTAS_PER_SM):  # no fewer threads to try
                break
        if C == least:
            T = cta_threads(S, k)
            if active_clusters(C, T) < 1:
                raise ValueError(f"FPS kernel: the device holds no cluster of {C} CTAs "
                                 f"of {T} threads for N={N}")
            return C, T
        C //= 2


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, N: int, C: int, T: int) -> int:
    n = _lib().pcm_fps_max_active_clusters(N, C, T, device)
    if n < 0:
        _build.check(-n, "fps cluster occupancy")
    return n


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_shape(B: int, N: int, device: int) -> tuple[int, int]:
    """(C, threads a CTA) of the kernel for B clouds of N points on CUDA
    device ``device``."""
    return choose_cluster(B, N, _sm_count(device),
                          lambda c, t: _active_clusters(device, N, c, t))


def farthest_point_sampling_padded_cuda(
    xyz: torch.Tensor, mask: torch.Tensor, npoints: int
) -> torch.Tensor:
    """(B, N, 3) f32 + (B, N) bool on a CUDA device -> (B, npoints) int32."""
    global LAUNCHES
    if not xyz.is_cuda or mask.device != xyz.device:
        raise ValueError(
            f"FPS kernel needs xyz and mask on one CUDA device, got "
            f"{xyz.device} and {mask.device}"
        )
    if xyz.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"FPS kernel takes f32 xyz and bool mask, got "
                        f"{xyz.dtype} and {mask.dtype}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3 or mask.shape != xyz.shape[:2]:
        raise ValueError(f"FPS kernel shapes: xyz {tuple(xyz.shape)}, mask "
                         f"{tuple(mask.shape)}; want (B, N, 3) and (B, N)")
    if not (xyz.is_contiguous() and mask.is_contiguous()):
        raise ValueError("FPS kernel needs contiguous xyz and mask")
    B, N, _ = xyz.shape
    lib = _lib()
    if not 1 <= N <= max_points() or npoints < 1:
        raise ValueError(f"FPS kernel takes 1 <= N <= {max_points()} and npoints >= 1, "
                         f"got N={N}, npoints={npoints}")
    out = torch.empty((B, npoints), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    device = xyz.device.index
    C, T = launch_shape(B, N, device)
    # the streamed points' min-distance caches, written by the kernel first
    work = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if cluster_slice(N, C) > MAX_SLICE else None)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.pcm_fps(xyz.data_ptr(), mask.data_ptr(), out.data_ptr(),
                      None if work is None else work.data_ptr(), B, N, npoints, C, T,
                      device, stream)
    _build.check(err, "fps")
    LAUNCHES += 1
    return out
