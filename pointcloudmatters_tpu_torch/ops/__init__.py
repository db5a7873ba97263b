"""Point ops and attention of the port, each hand-written CUDA kernel beside
its plain PyTorch version.

| TPU kernel (``pointcloudmatters_tpu/ops``) | CUDA kernel (``csrc``) | wrapper |
|---|---|---|
| ``pallas_fps.py`` ``_fps_kernel`` | ``fps.cu`` | ``ops/fps.py`` |
| ``pallas_knn3.py`` ``_knn3_kernel`` | ``knn.cu`` | ``ops/knn.py`` |
| ``oneshot_attention.py`` ``_fwd_kernel`` (rate 0) | ``attention_fwd.cu`` | ``ops/oneshot_attention.py`` |

Each wrapper counts its launches in a module-level ``LAUNCHES``;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

from pointcloudmatters_tpu_torch.ops import fps, knn, oneshot_attention

__all__ = ["launch_counts", "reset_launch_counts"]

_COUNTED = {"fps": fps, "knn": knn, "attention_fwd": oneshot_attention}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: mod.LAUNCHES for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.LAUNCHES = 0
