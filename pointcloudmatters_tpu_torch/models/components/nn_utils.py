"""Shared NN building blocks (port of
``pointcloudmatters_tpu/models/components/nn_utils.py``), inference side.

Parameter and buffer names are the JAX package's (``scale``/``bias``
parameters, ``mean``/``var`` running statistics), so converted checkpoints
map one to one. Batch statistics and dropout masks come with the training
step: here the norms use their running statistics and dropout is the
identity, and asking for anything else raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.ops.pointops import gather_rows_padded

__all__ = [
    "get_sinusoid_encoding_table",
    "activation_fn",
    "MaskedBatchNorm",
    "GroupedBNReluMax",
    "BitsDropout",
]


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> torch.Tensor:
    """(1, n_position, d_hid) interleaved sin/cos table, f32."""
    position = np.arange(n_position)[:, None]
    hid_j = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid_j // 2) / d_hid)
    table = np.where(hid_j % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table[None].astype(np.float32))


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry; ``gelu`` is the tanh form, as ``jax.nn.gelu``."""
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "glu": lambda x: F.glu(x, dim=-1),
        "silu": F.silu,
        "mish": lambda x: x * torch.tanh(F.softplus(x)),
    }
    if name not in table:
        raise RuntimeError(f"activation should be one of {sorted(table)}, not {name}.")
    return table[name]


class _RunningNorm(nn.Module):
    """Variables of a batch norm over the last axis: parameters
    ``scale``/``bias``, running ``mean``/``var``. ``momentum`` (torch
    convention, as in the JAX modules) is kept for the training step."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def eval_affine(self, use_running_average: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(eff_scale, eff_bias) on the running statistics:
        ``eff_scale = scale / sqrt(var + eps)``."""
        if not use_running_average:
            raise NotImplementedError(
                f"{type(self).__name__} batch statistics come with the "
                f"training step; only use_running_average=True is ported"
            )
        eff_scale = self.scale * torch.rsqrt(self.var + self.eps)
        return eff_scale, self.bias - self.mean * eff_scale


class MaskedBatchNorm(_RunningNorm):
    """Batch norm on running statistics, ``y = x * eff_scale + eff_bias``;
    ``mask`` only matters to batch statistics."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True) -> torch.Tensor:
        eff_scale, eff_bias = self.eval_affine(use_running_average)
        return x * eff_scale.to(x.dtype) + eff_bias.to(x.dtype)


class GroupedBNReluMax(_RunningNorm):
    """Point-token builder ``max_k(relu(BN(where(hole, 0, g[nn] - h))))``,
    the ``"xla"`` formulation of the JAX module.

    BN is one per-channel affine and ReLU is monotone, so the pool needs only
    the per-token max of the gathered rows where the effective scale is
    ``>= 0`` and their min where it is negative. A hole (``nn_idx < 0``)
    contributes an exact-zero row to the pool. Same variables as
    :class:`MaskedBatchNorm`."""

    def forward(self, g: torch.Tensor, h: torch.Tensor, nn_idx: torch.Tensor,
                use_running_average: bool = True, impl: str = "xla") -> torch.Tensor:
        """g: (B, N, D) projected source rows; h: (B, M, D) projected query
        offsets; nn_idx: (B, M, K) into N, -1 = hole -> (B, M, D)."""
        if impl != "xla":
            raise NotImplementedError(
                f"GroupedBNReluMax impl={impl!r}: the fused builder kernels "
                f"come with the data-source token builder; only 'xla' is ported"
            )
        eff_scale, eff_bias = self.eval_affine(use_running_average)
        hole = (nn_idx < 0)[..., None]  # (B, M, K, 1)
        x = gather_rows_padded(g, nn_idx) - h[:, :, None, :]
        vmax = torch.where(hole, -torch.inf, x).amax(dim=2)
        vmin = torch.where(hole, torch.inf, x).amin(dim=2)
        any_hole = hole.any(dim=2)  # (B, M, 1)
        xmax = torch.where(any_hole, torch.clamp_min(vmax, 0.0), vmax)
        xmin = torch.where(any_hole, torch.clamp_max(vmin, 0.0), vmin)
        eff_scale, eff_bias = eff_scale.to(h.dtype), eff_bias.to(h.dtype)
        sel = torch.where(eff_scale >= 0, xmax, xmin)
        return F.relu(sel * eff_scale + eff_bias)


class BitsDropout(nn.Module):
    """Dropout of the ACT residual streams; the identity at inference. The
    uint8-bits mask of the JAX module comes with the training step."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        raise NotImplementedError(
            "BitsDropout masks come with the training step; call with "
            "deterministic=True"
        )
