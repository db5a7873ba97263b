"""Point ops and attention of the port, each hand-written CUDA kernel beside
its plain PyTorch version.

| TPU kernel (``pointcloudmatters_tpu/ops``) | CUDA kernel (``csrc``) | wrapper |
|---|---|---|
| ``pallas_fps.py`` ``_fps_kernel`` | ``fps.cu`` | ``ops/fps.py`` |
| ``pallas_knn3.py`` ``_knn3_kernel`` | ``knn.cu`` | ``ops/knn.py`` |
| ``pallas_knn2.py`` ``_knn2_kernel`` | ``knn_chunkskip.cu`` | ``ops/knn_chunkskip.py`` |
| ``pallas_knn.py`` ``_knn_kernel`` | ``knn_baseline.cu`` | ``ops/knn_baseline.py`` |
| ``oneshot_attention.py`` ``_fwd_kernel`` (with ``_keep_mask``) | ``attention_fwd.cu`` | ``ops/oneshot_attention.py`` |
| ``oneshot_attention.py`` ``_bwd_kernel`` | ``attention_bwd.cu`` | ``ops/oneshot_attention.py`` |
| ``fused_builder.py`` ``_fwd_kernel`` | ``fused_builder.cu`` ``builder_fwd_kernel`` | ``ops/fused_builder.py`` |
| ``fused_builder.py`` ``_routed_kernel`` | ``fused_builder.cu`` ``routed_dw_kernel`` | ``ops/fused_builder.py`` |
| ``fused_mha.py`` ``_fwd_kernel`` | ``fused_mha.cu`` ``pcm_fused_mha_fwd`` (with ``attention_fwd.cuh``) | ``ops/fused_mha.py`` |
| ``fused_mha.py`` ``_bwd_kernel`` | ``fused_mha.cu`` ``pcm_fused_mha_bwd`` | ``ops/fused_mha.py`` |
| ``flash_attention.py`` ``_flash_attention_kernel`` | ``flash_attention.cu`` ``pcm_flash_fwd`` | ``ops/flash_attention.py`` |
| ``flash_attention.py`` ``_flash_attention_dkv_kernel`` | ``flash_attention.cu`` ``pcm_flash_bwd_dkv`` | ``ops/flash_attention.py`` |
| ``flash_attention.py`` ``_flash_attention_dq_kernel`` | ``flash_attention.cu`` ``pcm_flash_bwd_dq`` | ``ops/flash_attention.py`` |

Each wrapper counts its launches in a module-level counter (the attention,
fused-layer and flash wrappers one for each element type);
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

from pointcloudmatters_tpu_torch.ops import (
    flash_attention,
    fps,
    fused_builder,
    fused_mha,
    knn,
    knn_baseline,
    knn_chunkskip,
    oneshot_attention,
)

__all__ = ["launch_counts", "reset_launch_counts"]

# kernel name -> (wrapper module, its counter)
_COUNTED = {
    "fps": (fps, "LAUNCHES"),
    "knn": (knn, "LAUNCHES"),
    "knn_chunkskip": (knn_chunkskip, "LAUNCHES"),
    "knn_baseline": (knn_baseline, "LAUNCHES"),
    "attention_fwd": (oneshot_attention, "LAUNCHES"),
    "attention_bwd": (oneshot_attention, "BWD_LAUNCHES"),
    "attention_fwd_bf16": (oneshot_attention, "BF16_LAUNCHES"),
    "attention_bwd_bf16": (oneshot_attention, "BF16_BWD_LAUNCHES"),
    "builder_fwd": (fused_builder, "LAUNCHES"),
    "routed_dw": (fused_builder, "ROUTED_LAUNCHES"),
    "fused_mha_fwd": (fused_mha, "LAUNCHES"),
    "fused_mha_bwd": (fused_mha, "BWD_LAUNCHES"),
    "fused_mha_fwd_bf16": (fused_mha, "BF16_LAUNCHES"),
    "fused_mha_bwd_bf16": (fused_mha, "BF16_BWD_LAUNCHES"),
    "flash_fwd": (flash_attention, "FWD_LAUNCHES"),
    "flash_dkv": (flash_attention, "DKV_LAUNCHES"),
    "flash_dq": (flash_attention, "DQ_LAUNCHES"),
    "flash_fwd_bf16": (flash_attention, "BF16_FWD_LAUNCHES"),
    "flash_dkv_bf16": (flash_attention, "BF16_DKV_LAUNCHES"),
    "flash_dq_bf16": (flash_attention, "BF16_DQ_LAUNCHES"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
