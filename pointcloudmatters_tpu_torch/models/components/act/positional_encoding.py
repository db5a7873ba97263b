"""3-D sine embedding of point coordinates (port of
``coord_embedding_sine`` in
``pointcloudmatters_tpu/models/components/act/positional_encoding.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["coord_embedding_sine"]


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
