"""Wrapper of the farthest-point-sampling CUDA kernel (``csrc/fps.cu``).

Port of ``pointcloudmatters_tpu/ops/pallas_fps.py``; the kernel's design
notes are in its source. The plain PyTorch version with the same semantics
is ``ops.pointops.farthest_point_sampling_padded_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = ["farthest_point_sampling_padded_cuda", "LAUNCHES"]

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fps")
    if lib.pcm_fps.argtypes is None:
        lib.pcm_fps.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.pcm_fps.restype = ctypes.c_int
        lib.pcm_fps_max_points.argtypes = []
        lib.pcm_fps_max_points.restype = ctypes.c_int
    return lib


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
    if not 1 <= N <= lib.pcm_fps_max_points() or npoints < 1:
        raise ValueError(f"FPS kernel takes 1 <= N <= "
                         f"{lib.pcm_fps_max_points()} and npoints >= 1, got "
                         f"N={N}, npoints={npoints}")
    out = torch.empty((B, npoints), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.pcm_fps(xyz.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N,
                      npoints, xyz.device.index, stream)
    _build.check(err, "fps")
    LAUNCHES += 1
    return out
