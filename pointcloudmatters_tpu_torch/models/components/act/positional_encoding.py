"""Positional embeddings of ACT's observation tokens (port of
``pointcloudmatters_tpu/models/components/act/positional_encoding.py``).

``PositionEmbeddingSine`` and ``PositionEmbeddingLearned`` embed the cells
of a channel-last feature map ``(B, H, W, C)`` as ``(1, H * W, D)``, row
major; ``coord_embedding_sine`` embeds point coordinates. The 2-D sine
embedding is interleaved (sin at even slots, cos at odd), the 3-D one
blocked, each as its JAX counterpart.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["PositionEmbeddingSine", "PositionEmbeddingLearned", "coord_embedding_sine"]


def _sine_embed_1d(values: torch.Tensor, num_feats: int, temperature: float) -> torch.Tensor:
    """(...,) positions -> (..., num_feats), sin at even slots, cos at odd."""
    idx = torch.arange(num_feats, dtype=torch.float32, device=values.device)
    dim_t = temperature ** (2 * torch.floor(idx / 2) / num_feats)
    pos = values[..., None] / dim_t
    return torch.where(idx % 2 == 0, torch.sin(pos), torch.cos(pos))


class PositionEmbeddingSine(nn.Module):
    """2-D sine embedding (JAX ``positional_encoding.py:29-57``): 1-based
    row and column positions, divided by ``H + 1e-6`` (``W + 1e-6``) and
    times ``scale`` (2 pi unless given) with ``normalize``; the row's
    ``num_pos_feats`` features, then the column's. f32 whatever the map's
    type; no parameters."""

    def __init__(self, num_pos_feats: int = 64, temperature: float = 10000.0,
                 normalize: bool = False, scale: Optional[float] = None):
        super().__init__()
        if scale is not None and not normalize:
            raise ValueError("normalize should be True if scale is passed")
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = 2 * math.pi if scale is None else scale

    def forward(self, feature_map: torch.Tensor) -> torch.Tensor:
        H, W = feature_map.shape[-3], feature_map.shape[-2]
        dev = feature_map.device
        y = torch.arange(1, H + 1, dtype=torch.float32, device=dev)[:, None].expand(H, W)
        x = torch.arange(1, W + 1, dtype=torch.float32, device=dev)[None, :].expand(H, W)
        if self.normalize:
            eps = 1e-6
            y = y / (H + eps) * self.scale
            x = x / (W + eps) * self.scale
        pos = torch.cat([_sine_embed_1d(y, self.num_pos_feats, self.temperature),
                         _sine_embed_1d(x, self.num_pos_feats, self.temperature)], dim=-1)
        return pos.reshape(1, H * W, -1)


class PositionEmbeddingLearned(nn.Module):
    """Learned 50 x 50 embedding (JAX ``positional_encoding.py:60-80``):
    ``[col_embed[x], row_embed[y]]`` a cell; the tables drawn uniform in
    [0, 1), as flax's ``uniform(1.0)``."""

    def __init__(self, num_pos_feats: int = 256):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Parameter(torch.zeros(50, num_pos_feats))
        self.col_embed = nn.Parameter(torch.zeros(50, num_pos_feats))

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        for p in (self.row_embed, self.col_embed):
            p.copy_(torch.rand(p.shape, generator=generator))

    def forward(self, feature_map: torch.Tensor) -> torch.Tensor:
        H, W = feature_map.shape[-3], feature_map.shape[-2]
        F = self.num_pos_feats
        pos = torch.cat([self.col_embed[:W][None, :, :].expand(H, W, F),
                         self.row_embed[:H][:, None, :].expand(H, W, F)], dim=-1)
        return pos.reshape(1, H * W, -1)


def coord_embedding_sine(
    coord: torch.Tensor,
    hidden_dim: int,
    temperature: float = 10000.0,
    normalize: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(..., 3) xyz -> (..., hidden_dim); each axis gets ``hidden_dim // 3``
    features, the remainder is zero-padded.

    The per-axis layout is BLOCKED, not interleaved — all sines of the even
    frequencies, then all cosines of the odd ones — the reference quirk the
    JAX module keeps (its ``positional_encoding.py:114-131``)."""
    if scale is not None and not normalize:
        raise ValueError("normalize should be True if scale is passed")
    if scale is None:
        scale = 2 * math.pi
    num_pos_feats = hidden_dim // 3
    num_pad_feats = hidden_dim - num_pos_feats * 3
    x, y, z = coord[..., 0], coord[..., 1], coord[..., 2]
    if normalize:
        eps = 1e-6
        x = x / (x.max() + eps) * scale
        y = y / (y.max() + eps) * scale
        z = z / (z.max() + eps) * scale

    idx = torch.arange(num_pos_feats, dtype=torch.float32, device=coord.device)
    dim_t = temperature ** (2 * torch.floor(idx / 2) / num_pos_feats)

    def axis_embed(v):
        vals = v[..., None] / dim_t
        return torch.cat(
            [torch.sin(vals[..., 0::2]), torch.cos(vals[..., 1::2])], dim=-1
        )

    pos = torch.cat([axis_embed(x), axis_embed(y), axis_embed(z)], dim=-1)
    if num_pad_feats:
        pad = pos.new_zeros(pos.shape[:-1] + (num_pad_feats,))
        pos = torch.cat([pos, pad], dim=-1)
    return pos
