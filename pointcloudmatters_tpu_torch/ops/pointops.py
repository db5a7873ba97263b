"""Point-cloud primitives over padded batches (port of
``pointcloudmatters_tpu/ops/pointops.py:80-322, 531``).

Layout and semantics are the JAX package's: fixed-shape ``(B, N, ...)``
clouds with a ``(B, N)`` bool validity mask.

- FPS seeds at index 0 and argmaxes a running min-distance cache; invalid
  points carry -1; rows with fewer valid points than ``npoints`` repeat
  indices; exact ties go to the smaller index.
- kNN returns squared distances ascending, ties to the smaller index, and
  index -1 / distance 1e10 where a row has fewer than k valid points.

Every squared distance is computed elementwise as
``|a|^2 + |b|^2 - 2 (a0 b0 + a1 b1 + a2 b2)``, in that order, never as a
matmul: the CUDA kernels compute the same expression with round-to-nearest
intrinsics, so kernel and plain version agree bit for bit on the card, and
neither can fall into TF32.

Dispatch: a CPU tensor runs the plain PyTorch version, a CUDA tensor the
hand-written kernel (``ops/fps.py``, ``ops/knn.py``), which raises on
anything it does not take.
"""

from __future__ import annotations

import torch

from pointcloudmatters_tpu_torch.ops import fps as _fps
from pointcloudmatters_tpu_torch.ops import knn as _knn

__all__ = [
    "farthest_point_sampling_padded",
    "farthest_point_sampling_padded_plain",
    "knn_query_padded",
    "knn_query_padded_plain",
    "gather_rows_padded",
]

_BIG = 1.0e10


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) as p0 p0 + p1 p1 + p2 p2, left to right."""
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def farthest_point_sampling_padded_plain(
    xyz: torch.Tensor, mask: torch.Tensor, npoints: int
) -> torch.Tensor:
    """Iterative FPS, (B, N, 3) + (B, N) bool -> (B, npoints) int32.

    Plain PyTorch version of the FPS kernel, with the semantics of
    ``_farthest_point_sampling_padded_xla``. Ties are broken explicitly
    (the smallest index among the maxima), not left to ``argmax``."""
    B, N, _ = xyz.shape
    valid = mask.to(torch.bool)
    x0, x1, x2 = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    x_sq = _sq_norm(xyz)
    dist = torch.where(valid, _BIG, -1.0).to(xyz.dtype)
    col = torch.arange(N, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    out = torch.zeros((B, npoints), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    for i in range(1, npoints):
        px = x0[rows, last][:, None]
        py = x1[rows, last][:, None]
        pz = x2[rows, last][:, None]
        p2 = x_sq[rows, last][:, None]
        d = x_sq + p2 - 2.0 * (x0 * px + x1 * py + x2 * pz)
        dist = torch.where(valid, torch.minimum(dist, d), dist)
        top = dist.amax(dim=1, keepdim=True)
        last = torch.where(dist >= top, col, N).amin(dim=1)
        out[:, i] = last.to(torch.int32)
    return out


def knn_query_padded_plain(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (B, M, 3) queries, (B, N, 3) points, (B, N) bool ->
    idx (B, M, nsample) int32, d2 (B, M, nsample) f32.

    Plain PyTorch version of the kNN kernel, with the semantics of
    ``knn_query_padded``. A stable sort orders equal distances by index.
    One cloud at a time bounds the (M, N) distance matrix."""
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    valid = mask.to(torch.bool)
    q_sq, p_sq = _sq_norm(new_xyz), _sq_norm(xyz)
    idx_rows, d2_rows = [], []
    for b in range(B):
        q, p = new_xyz[b][:, None, :], xyz[b][None, :, :]
        dot = q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1] + q[..., 2] * p[..., 2]
        d2 = torch.clamp_min(q_sq[b][:, None] + p_sq[b][None, :] - 2.0 * dot, 0.0)
        d2 = torch.where(valid[b][None, :], d2, _BIG)
        if N < nsample:
            d2 = torch.nn.functional.pad(d2, (0, nsample - N), value=_BIG)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        vals, order = vals[:, :nsample], order[:, :nsample]
        idx_rows.append(torch.where(vals >= _BIG, -1, order).to(torch.int32))
        d2_rows.append(vals)
    return torch.stack(idx_rows), torch.stack(d2_rows)


def farthest_point_sampling_padded(
    xyz: torch.Tensor, mask: torch.Tensor, npoints: int
) -> torch.Tensor:
    """Iterative FPS over padded batches; see
    :func:`farthest_point_sampling_padded_plain` for semantics. f32 geometry,
    as the TPU kernel casts it."""
    xyz = xyz.to(torch.float32)
    mask = mask.to(torch.bool)
    if xyz.device.type == "cpu":
        return farthest_point_sampling_padded_plain(xyz, mask, npoints)
    return _fps.farthest_point_sampling_padded_cuda(
        xyz.contiguous(), mask.contiguous(), npoints
    )


def knn_query_padded(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over padded batches; see :func:`knn_query_padded_plain`
    for semantics. f32 geometry, as the TPU kernel casts it."""
    new_xyz = new_xyz.to(torch.float32)
    xyz = xyz.to(torch.float32)
    mask = mask.to(torch.bool)
    if new_xyz.device.type == "cpu":
        return knn_query_padded_plain(new_xyz, xyz, mask, nsample)
    return _knn.knn_query_padded_cuda(
        new_xyz.contiguous(), xyz.contiguous(), mask.contiguous(), nsample
    )


def gather_rows_padded(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather ``feat[b, idx[b, ...], :]`` ->
    ``(B, *idx.shape[1:], C)``; negative indices read row 0 (callers mask
    holes themselves)."""
    B, N, C = feat.shape
    off = (torch.arange(B, device=feat.device) * N).reshape(
        (B,) + (1,) * (idx.ndim - 1)
    )
    rows = (idx.to(torch.long).clamp_min(0) + off).reshape(-1)
    return feat.reshape(B * N, C)[rows].reshape(idx.shape + (C,))
