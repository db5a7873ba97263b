"""PointNet encoder, a masked per-point MLP (port of
``pointcloudmatters_tpu/models/components/pcd_encoder/pointnet.py``).

Five bias-free linears of widths (64, 64, 64, 128, 512), each followed by a
batch norm (eps 1e-3, momentum 0.01) and a ReLU, over the padded
``(B, N, C_in)`` cloud; names ``conv1..5`` / ``bn1..5`` as in JAX. ``group``
is the process group the batch norms sum their statistics over (the JAX
module's ``axis_name``; None: the default group, when one is initialised).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.nn_utils import MaskedBatchNorm

__all__ = ["PointNet"]

WIDTHS = (64, 64, 64, 128, 512)


class PointNet(nn.Module):
    """Per-point feature extractor: ``forward({"feat": (B, N, C_in),
    "valid": (B, N)})`` -> (B, N, 512), or ``num_classes`` channels."""

    def __init__(self, in_channels: int, num_classes: int = 0, group=None):
        super().__init__()
        self.in_channels = in_channels
        self.num_classes = num_classes
        c_in = in_channels
        for i, width in enumerate(WIDTHS):
            setattr(self, f"conv{i + 1}", nn.Linear(c_in, width, bias=False))
            setattr(self, f"bn{i + 1}",
                    MaskedBatchNorm(width, momentum=0.01, eps=1e-3, group=group))
            c_in = width
        if num_classes > 0:
            self.final = nn.Linear(c_in, num_classes)

    @property
    def num_channels(self) -> int:
        return self.num_classes if self.num_classes > 0 else WIDTHS[-1]

    def forward(self, input_dict: dict, train: bool = False) -> torch.Tensor:
        x = input_dict["feat"]
        mask = input_dict.get("valid")
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected feat[...,-1] == {self.in_channels}, got {x.shape[-1]}"
            )
        for i in range(len(WIDTHS)):
            x = getattr(self, f"conv{i + 1}")(x)
            x = getattr(self, f"bn{i + 1}")(x, mask=mask,
                                            use_running_average=not train)
            x = F.relu(x)
        if self.num_classes > 0:
            x = self.final(x)
        return x
