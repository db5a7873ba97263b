"""Point-cloud observation encoder of the Diffusion Policy (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/vision/pcd_obs_encoder.py``).

Per-point backbone features -> FPS to ``pcd_npoints`` -> kNN groups of
``pcd_nsample`` -> linear, batch norm, ReLU and max over each group (the
``GroupedBNReluMax`` token builder) -> pointwise projector with batch norms
and ReLU, a max over the tokens, a final linear and batch norm: one feature
vector a cloud, with the low-dimensional observations concatenated. The
clouds are padded ``(B * To, N, ...)`` with a validity mask, as the collate
gives them; FPS and kNN are the port's (the CUDA kernels on the card, their
plain versions on the CPU).

With ``pre_sample`` the raw cloud is sampled and grouped first and the
backbone runs over the tokens; with ``use_mask`` FPS draws
``pcd_npoints * (1 - bg_ratio)`` tokens from the foreground (``mask``) and
the rest from the background. Parameter names are the JAX module's.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.nn_utils import (
    GroupedBNReluMax,
    MaskedBatchNorm,
    group_tokens,
)

__all__ = ["PCDObsEncoder"]


def _gather_points(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C) at idx (B, M) -> (B, M, C)."""
    return torch.gather(values, 1, idx.to(torch.long)[..., None].expand(-1, -1, values.shape[-1]))


class PCDObsEncoder(nn.Module):
    """``forward(obs_dict, train)`` -> (B * To, F): each ``pcd`` key of
    ``shape_meta["obs"]`` encoded to ``output_dim`` features, then each
    ``low_dim`` key, in sorted key order (:attr:`feature_dim` in all)."""

    def __init__(self, shape_meta: Any, pcd_model: nn.Module, share_pcd_model: bool = True,
                 n_obs_step: int = 2, pcd_nsample: int = 16, pcd_npoints: int = 1024,
                 use_mask: bool = False, bg_ratio: float = 0.0, pcd_hidden_dim: int = 128,
                 projector_layers: int = 2, projector_channels: Sequence[int] = (128, 128, 128),
                 pre_sample: bool = False, in_channel: int = 6):
        super().__init__()
        self.shape_meta = shape_meta
        self.share_pcd_model = share_pcd_model
        self.n_obs_step = n_obs_step
        self.pcd_nsample = pcd_nsample
        self.pcd_npoints = pcd_npoints
        self.use_mask = use_mask
        self.bg_ratio = bg_ratio
        self.projector_layers = projector_layers
        self.projector_channels = list(projector_channels)
        self.pre_sample = pre_sample
        meta = shape_meta["obs"]
        self.pcd_keys = sorted(k for k, a in meta.items() if a.get("type", "low_dim") == "pcd")
        self.low_dim_keys = sorted(k for k, a in meta.items()
                                   if a.get("type", "low_dim") == "low_dim")
        self.low_dim_width = sum(math.prod(meta[k]["shape"]) for k in self.low_dim_keys)
        self.pcd_model = pcd_model
        # pre_sample groups the raw cloud (its in_channel features) into
        # in_channel-wide tokens for the backbone; else the backbone's
        # features into pcd_hidden_dim-wide tokens for the projector
        proj_in = in_channel if pre_sample else pcd_hidden_dim
        feat_dim = in_channel if pre_sample else pcd_model.num_channels
        self.linear = nn.Linear(3 + feat_dim, proj_in, bias=False)
        self.bn = GroupedBNReluMax(proj_in)
        width = pcd_model.num_channels if pre_sample else proj_in
        for i in range(projector_layers):
            setattr(self, f"projector_conv{i}", nn.Linear(width, self.projector_channels[i]))
            setattr(self, f"projector_bn{i}", MaskedBatchNorm(self.projector_channels[i]))
            width = self.projector_channels[i]
        self.projector_out = nn.Linear(width, self.output_dim)
        self.projector_out_bn = MaskedBatchNorm(self.output_dim)

    @property
    def output_dim(self) -> int:
        """Features a cloud, before the low-dimensional keys."""
        return self.projector_channels[self.projector_layers]

    @property
    def feature_dim(self) -> int:
        """Features an observation frame: every cloud's and the low-dim keys'."""
        return len(self.pcd_keys) * self.output_dim + self.low_dim_width

    def pcd_sampling(self, coord: torch.Tensor, feat: torch.Tensor, valid: torch.Tensor,
                     fg_mask: Optional[torch.Tensor] = None, train: bool = False,
                     feat_is_data: bool = False):
        """-> (new_xyz (B, m, 3), tokens (B, m, D), idx (B, m)): the token
        builder ``nn_utils.group_tokens`` that ``ACTPCD`` shares, with
        ``use_mask``'s foreground split."""
        return group_tokens(self.linear, self.bn, coord, feat, valid, self.pcd_npoints,
                            self.pcd_nsample, fg_mask if self.use_mask else None,
                            self.bg_ratio, train=train, feat_is_data=feat_is_data)

    def encode_pcd(self, pcd_dict: dict, train: bool) -> torch.Tensor:
        coord = pcd_dict["coord"]
        valid = pcd_dict["valid"].to(torch.bool)
        fg_mask = pcd_dict.get("mask") if self.use_mask else None
        if self.pre_sample:
            new_xyz, feat, idx = self.pcd_sampling(coord, pcd_dict["feat"], valid, fg_mask,
                                                   train=train, feat_is_data=True)
            sampled = dict(pcd_dict, coord=new_xyz, feat=feat,
                           valid=torch.ones(idx.shape, dtype=torch.bool, device=idx.device))
            if "grid_coord" in pcd_dict:
                sampled["grid_coord"] = _gather_points(pcd_dict["grid_coord"], idx)
            x = self.pcd_model(sampled, train=train)
        else:
            features = self.pcd_model(pcd_dict, train=train)
            _, x, _ = self.pcd_sampling(coord, features, valid, fg_mask, train=train)
        for i in range(self.projector_layers):
            x = getattr(self, f"projector_conv{i}")(x)
            x = getattr(self, f"projector_bn{i}")(x, use_running_average=not train)
            x = F.relu(x)
        x = x.amax(dim=1)  # (B, C)
        x = self.projector_out(x)
        return self.projector_out_bn(x, use_running_average=not train)

    def forward(self, obs_dict: dict, train: bool = False,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        """``rngs`` is taken as every observation encoder of the policy takes
        it; this one draws nothing."""
        features = []
        batch_size: Optional[int] = None
        for key in self.pcd_keys:
            feat = self.encode_pcd(obs_dict[key], train)
            batch_size = feat.shape[0]
            features.append(feat)
        for key in self.low_dim_keys:
            data = obs_dict[key]
            if batch_size is not None and data.shape[0] != batch_size:
                raise ValueError(f"{key}: {tuple(data.shape)} for {batch_size} clouds")
            features.append(data)
        return torch.cat(features, dim=-1)
