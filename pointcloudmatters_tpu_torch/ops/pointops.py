"""Point-cloud primitives (port of ``pointcloudmatters_tpu/ops/pointops.py``).

Layout and semantics are the JAX package's: fixed-shape ``(B, N, ...)``
clouds with a ``(B, N)`` bool validity mask, and, for the reference's
packed signatures, ``(n, ...)`` points with ``offset`` prefix sums.

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
hand-written kernel (``ops/fps.py``, ``ops/knn.py``, ``ops/knn_chunkskip.py``,
``ops/knn_baseline.py``), which raises on anything it does not take.
:func:`knn_query_padded` picks its kNN backend as JAX does, from
``PCM_KNN_IMPL`` (:func:`knn_route`).

The library surface that no config uses (JAX ``pointops.py:330-817``), with
JAX's semantics on tensors of the caller's device (JAX's packed wrappers
return numpy):

- ball query keeps ``d2 <= 1e-5 or min_r^2 <= d2 < max_r^2``, sorted
  stably by distance, evenly strided down (``int(f32(cnt) / nsample * k)``)
  when oversampled; its random variant orders the candidates by a (B, 1, N)
  uniform priority drawn from a ``torch.Generator`` (:func:`uniform_priority`);
  their distances are JAX's ``_sqdist`` expansion
  ``|a|^2 + |b|^2 - 2 a.b``, elementwise in f32 (no TF32 path);
- grouping, subtraction, aggregation and interpolation gather with holes
  (-1) read as row 0 or zero, as there; ``interpolation``, ``knn_query``,
  ``query_and_group`` and the packed FPS go through :func:`knn_query_padded`
  and :func:`farthest_point_sampling_padded`, so the kernels on the card;
- ``attention_fusion_step`` sums its edges by a stable sort of the targets
  and a segmented scan, with no atomics: deterministic on the card.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.ops import fps as _fps
from pointcloudmatters_tpu_torch.ops import knn as _knn
from pointcloudmatters_tpu_torch.ops import knn_baseline as _knn_baseline
from pointcloudmatters_tpu_torch.ops import knn_chunkskip as _knn_chunkskip

__all__ = [
    "farthest_point_sampling_padded",
    "farthest_point_sampling_padded_plain",
    "knn_query_padded",
    "knn_query_padded_plain",
    "knn_query_chunkskip",
    "knn_query_chunkskip_plain",
    "knn_query_baseline_plain",
    "knn_route",
    "KNN_IMPLS",
    "morton_codes_padded",
    "spatial_sort_order",
    "gather_rows_padded",
    # the library surface
    "ball_query_padded",
    "random_ball_query_padded",
    "uniform_priority",
    "grouping_padded",
    "subtraction_padded",
    "aggregation_padded",
    "interpolation_padded",
    "knn_query_and_group_padded",
    "attention_relation_step",
    "attention_fusion_step",
    "offset2bincount",
    "offset2batch",
    "batch2offset",
    "farthest_point_sampling",
    "knn_query",
    "ball_query",
    "random_ball_query",
    "grouping",
    "grouping2",
    "interpolation",
    "interpolation2",
    "subtraction",
    "aggregation",
    "knn_query_and_group",
    "ball_query_and_group",
    "query_and_group",
]

_BIG = 1.0e10
_INT32_MAX = 2**31 - 1
# PCM_KNN_IMPL values, as JAX takes them (v3 is the default)
KNN_IMPLS = ("v3", "chunkskip", "baseline")


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


def _chunk_d2(q, q_sq, p, p_sq, valid) -> torch.Tensor:
    """(..., Mq, 3) queries with their squared norms, (..., Np, 3) points
    with theirs and their (..., Np) validity -> (..., Mq, Np) squared
    distances, the kernels' expression, clamped at 0 and 1e10 where a point
    is invalid."""
    qe, pe = q[..., :, None, :], p[..., None, :, :]
    dot = qe[..., 0] * pe[..., 0] + qe[..., 1] * pe[..., 1] + qe[..., 2] * pe[..., 2]
    d2 = torch.clamp_min(q_sq[..., :, None] + p_sq[..., None, :] - 2.0 * dot, 0.0)
    return torch.where(valid[..., None, :], d2, _BIG)


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
        d2 = _chunk_d2(new_xyz[b], q_sq[b], xyz[b], p_sq[b], valid[b])
        if N < nsample:
            d2 = torch.nn.functional.pad(d2, (0, nsample - N), value=_BIG)
        vals, order = torch.sort(d2, dim=-1, stable=True)
        vals, order = vals[:, :nsample], order[:, :nsample]
        idx_rows.append(torch.where(vals >= _BIG, -1, order).to(torch.int32))
        d2_rows.append(vals)
    return torch.stack(idx_rows), torch.stack(d2_rows)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with ``rows`` rows of zeros (False) appended along dim 1."""
    if rows == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], rows) + t.shape[2:])], dim=1)


def _merge_k(best_d, best_i, d2, cand_i, k):
    """The k smallest (distance, index) pairs of the running k-best and a
    chunk's candidates, ascending: on equal distances the smaller index.
    ``cand_i`` broadcasts against ``d2``."""
    d = torch.cat([best_d, d2], dim=-1)
    i = torch.cat([best_i, cand_i.expand(d2.shape)], dim=-1)
    by_index = torch.argsort(i, dim=-1, stable=True)
    d, i = d.gather(-1, by_index), i.gather(-1, by_index)
    order = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return d.gather(-1, order), i.gather(-1, order)


def _k_best(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An empty running k-best: distance 1e10 and an index after every
    point's, as the kernels' lists start."""
    return (torch.full(shape, _BIG, dtype=torch.float32, device=device),
            torch.full(shape, _INT32_MAX, dtype=torch.int64, device=device))


def knn_query_chunkskip_plain(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int,
    with_skipped: bool = False, tm: int = 128,
):
    """Plain PyTorch version of the chunk-skip kNN kernel 12
    (``csrc/knn_chunkskip.cu``), following the TPU kernel's traversal
    (``pallas_knn2.py:65-107``): the queries in ``tm``-query tiles (the
    TPU's 128 by default; the kernel's tile is chosen by
    ``ops.knn_chunkskip.choose_tile``); the cloud in
    ``tn = min(512, max(N, 128))``-point chunks, visited in the ring order
    c0, c0+1, c0-1, c0+2, ... (mod n_chunks) from the tile's home chunk
    ``c0 = qt * n_chunks // n_tiles``; a chunk merged into the running
    k-best only when its smallest distance can beat the tile's worst k-th
    best. Query rows past M take part in neither.

    Exact on any query order, and index for index
    :func:`knn_query_padded_plain`: the k-best is ordered by (distance,
    index), so exact ties go to the smaller index (the TPU leaves their order
    unspecified), and a chunk is skipped only when its minimum is strictly
    greater than the tile's worst k-th best (the TPU skips at ``>=``; a point
    at that distance with a smaller index must still enter). With
    ``with_skipped`` also a 0-d int32 tensor: the (tile, chunk) pairs
    skipped, as the kernel counts them."""
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = new_xyz.device
    tn = min(512, max(N, 128))
    n_tiles, n_chunks = -(-M // tm), -(-N // tn)
    q = _pad_rows(new_xyz, n_tiles * tm - M).reshape(B, n_tiles, tm, 3)
    active = (torch.arange(n_tiles * tm, device=dev) < M).reshape(n_tiles, tm)
    p = _pad_rows(xyz, n_chunks * tn - N).reshape(B, n_chunks, tn, 3)
    valid = _pad_rows(mask.to(torch.bool), n_chunks * tn - N).reshape(B, n_chunks, tn)
    q_sq, p_sq = _sq_norm(q), _sq_norm(p)
    best_d, best_i = _k_best((B, n_tiles, tm, nsample), dev)
    c0 = torch.arange(n_tiles, device=dev) * n_chunks // n_tiles
    col = torch.arange(tn, device=dev)
    skipped = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(n_chunks):
        off = (j + 1) // 2
        c = (c0 + (off if j % 2 else -off) + n_chunks) % n_chunks  # each tile's chunk
        d2 = _chunk_d2(q, q_sq, p[:, c], p_sq[:, c], valid[:, c])  # (B, tiles, tm, tn)
        chunk_min = torch.where(active[..., None], d2, float("inf")).amin(dim=(-2, -1))
        tau = torch.where(active, best_d[..., -1], -float("inf")).amax(dim=-1)
        merge = (chunk_min <= tau)[..., None, None]
        skipped += (~merge).sum().to(torch.int32)
        cand_i = torch.where(valid[:, c], c[:, None] * tn + col, _INT32_MAX)[:, :, None, :]
        new_d, new_i = _merge_k(best_d, best_i, d2, cand_i, nsample)
        best_d = torch.where(merge, new_d, best_d)
        best_i = torch.where(merge, new_i, best_i)
    best_d = best_d.reshape(B, n_tiles * tm, nsample)[:, :M]
    best_i = best_i.reshape(B, n_tiles * tm, nsample)[:, :M]
    idx = torch.where(best_d >= _BIG, -1, best_i).to(torch.int32)
    return (idx, best_d, skipped) if with_skipped else (idx, best_d)


def knn_query_baseline_plain(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dense-scan kNN kernel 13
    (``csrc/knn_baseline.cu``), following the TPU kernel's traversal
    (``pallas_knn.py:49-78``): the cloud in ``tn = min(2048, max(N,
    128))``-point chunks in index order, each merged into the running
    k-best, ties to the smaller index; index for index
    :func:`knn_query_padded_plain`."""
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    tn = min(2048, max(N, 128))
    valid = mask.to(torch.bool)
    q_sq, p_sq = _sq_norm(new_xyz), _sq_norm(xyz)
    best_d, best_i = _k_best((B, M, nsample), new_xyz.device)
    for base in range(0, N, tn):
        end = min(base + tn, N)
        d2 = _chunk_d2(new_xyz, q_sq, xyz[:, base:end], p_sq[:, base:end], valid[:, base:end])
        cand_i = torch.where(valid[:, base:end],
                             torch.arange(base, end, device=xyz.device), _INT32_MAX)
        best_d, best_i = _merge_k(best_d, best_i, d2, cand_i[:, None, :], nsample)
    return torch.where(best_d >= _BIG, -1, best_i).to(torch.int32), best_d


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


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (the 32-bit Morton dilation), int32."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes_padded(coord: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, N) bool -> (B, N) int32 Morton codes, INT32_MAX where
    invalid: the coordinates quantised to a 10-bit grid over each cloud's
    valid bounding box, in f32, as ``pointops.morton_codes_padded`` computes
    them. Purely an ordering key: no kNN result depends on it."""
    c = coord.to(torch.float32)
    v = valid.to(torch.bool)
    lo = torch.where(v[..., None], c, _BIG).amin(dim=1, keepdim=True)
    hi = torch.where(v[..., None], c, -_BIG).amax(dim=1, keepdim=True)
    extent = torch.clamp_min(hi - lo, 1e-6)
    # a true division: ``1023.0 / extent`` would be extent.reciprocal() * 1023
    scale = torch.full_like(extent, 1023.0) / extent
    q = torch.clamp((c - lo) * scale, 0.0, 1023.0).to(torch.int32)
    code = _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1) | (_part1by2(q[..., 2]) << 2)
    return torch.where(v, code, _INT32_MAX)


def spatial_sort_order(coord: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N) int32 permutation: the valid points in Morton order (stable on
    equal codes), the invalid ones after them."""
    return torch.argsort(morton_codes_padded(coord, valid), dim=-1, stable=True).to(torch.int32)


def knn_route(impl: str, n_points: int, nsample: int, device_type: str) -> str:
    """The kNN backend of :func:`knn_query_padded`, JAX's gate
    (``pointops.py:285-322``) on the port's devices: ``"v3"`` (kernel 2),
    ``"chunkskip"`` (kernel 12 on Morton-sorted queries), ``"baseline"``
    (kernel 13) or ``"plain"`` (:func:`knn_query_padded_plain`).

    ``impl`` is ``PCM_KNN_IMPL``; any value but ``KNN_IMPLS`` raises
    ``ValueError``, on every device. A CPU tensor, like JAX off the TPU, and
    ``nsample > 128`` take the plain version. On CUDA, ``v3`` takes kernel 2
    while the TPU kernel's distance row fits its 8 MiB
    (``ceil(N / 128) * 128 * 128 * 4`` bytes, N <= 16,384), and kernel 12
    above; ``chunkskip`` kernel 12 and ``baseline`` kernel 13. Kernel 2 has
    no such limit on the card: the term stays so that both packages route
    the same shapes."""
    if impl not in KNN_IMPLS:
        raise ValueError(f"PCM_KNN_IMPL must be one of {', '.join(map(repr, KNN_IMPLS))}; "
                         f"got {impl!r}")
    if device_type != "cuda" or nsample > _knn.MAX_K:
        return "plain"
    if impl == "v3" and -(-n_points // 128) * 128 * 128 * 4 <= 8 * 2**20:
        return "v3"
    return "baseline" if impl == "baseline" else "chunkskip"


def knn_query_chunkskip(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 12's route (``pointops.py:301-316``): the queries sorted along
    a Morton curve (:func:`spatial_sort_order`, every query valid), the
    chunk-skip kNN on them (on a CPU tensor its plain version), the results
    put back in query order. f32 geometry; index for index
    :func:`knn_query_padded_plain`."""
    new_xyz, xyz, mask = new_xyz.to(torch.float32), xyz.to(torch.float32), mask.to(torch.bool)
    all_valid = torch.ones(new_xyz.shape[:2], dtype=torch.bool, device=new_xyz.device)
    perm = spatial_sort_order(new_xyz, all_valid).long()
    inv = torch.argsort(perm, dim=-1)
    q = torch.gather(new_xyz, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    if q.device.type == "cpu":
        idx, d2 = knn_query_chunkskip_plain(q, xyz, mask, nsample)
    else:
        idx, d2 = _knn_chunkskip.knn_query_chunkskip_cuda(
            q, xyz.contiguous(), mask.contiguous(), nsample)
    back = inv[..., None].expand(-1, -1, nsample)
    return torch.gather(idx, 1, back), torch.gather(d2, 1, back)


def knn_query_padded(
    new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over padded batches; see :func:`knn_query_padded_plain`
    for semantics. f32 geometry, as the TPU kernels cast it. Reads
    ``PCM_KNN_IMPL`` (default ``v3``) on every call and takes the backend
    :func:`knn_route` names; every backend gives the same indices."""
    new_xyz = new_xyz.to(torch.float32)
    xyz = xyz.to(torch.float32)
    mask = mask.to(torch.bool)
    route = knn_route(os.environ.get("PCM_KNN_IMPL", "v3"), xyz.shape[1], nsample,
                      new_xyz.device.type)
    if route == "plain":
        return knn_query_padded_plain(new_xyz, xyz, mask, nsample)
    if route == "chunkskip":
        return knn_query_chunkskip(new_xyz, xyz, mask, nsample)
    kernel = (_knn.knn_query_padded_cuda if route == "v3"
              else _knn_baseline.knn_query_baseline_cuda)
    return kernel(new_xyz.contiguous(), xyz.contiguous(), mask.contiguous(), nsample)


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


# ---------------------------------------------------------------------------
# the library surface: ball queries, grouping, interpolation, edge attention
# ---------------------------------------------------------------------------

def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared distances by JAX's
    ``_sqdist`` expansion ``|a|^2 + |b|^2 - 2 a.b``, clamped at 0, in f32
    (elementwise: no matmul, so no TF32)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    ae, be = a[..., :, None, :], b[..., None, :, :]
    dot = ae[..., 0] * be[..., 0] + ae[..., 1] * be[..., 1] + ae[..., 2] * be[..., 2]
    return torch.clamp_min(_sq_norm(a)[..., :, None] + _sq_norm(b)[..., None, :] - 2.0 * dot,
                           0.0)


def _in_ball(d2: torch.Tensor, mask: torch.Tensor, max_radius: float,
             min_radius: float) -> torch.Tensor:
    """The ball query's candidates: the point itself (``d2 <= 1e-5``) or
    ``min_r^2 <= d2 < max_r^2``, valid points only."""
    in_range = (d2 <= 1e-5) | ((d2 >= min_radius ** 2) & (d2 < max_radius ** 2))
    return in_range & mask.to(torch.bool)[:, None, :]


def ball_query_padded(new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor,
                      nsample: int, max_radius: float, min_radius: float = 0.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Radius query (B, M, 3), (B, N, 3), (B, N) -> idx (B, M, nsample)
    int32, d2 f32: the candidates sorted stably by distance; with more than
    ``nsample`` of them every ``cnt / nsample``-th (``int(f32(cnt) /
    nsample * k)``), else the first ``cnt`` and -1 / 1e10 after."""
    N = xyz.shape[1]
    d2 = _sqdist(new_xyz, xyz)
    in_range = _in_ball(d2, mask, max_radius, min_radius)
    d2s = torch.where(in_range, d2, _BIG)
    d2_sorted, order = torch.sort(d2s, dim=-1, stable=True)
    cnt = in_range.sum(dim=-1)[..., None]  # (B, M, 1)
    k = torch.arange(nsample, device=d2.device)
    # a true division: a Python divisor is a product with its reciprocal on the card
    sep = cnt.to(torch.float32) / torch.full((), float(nsample), device=d2.device)
    strided = (sep * k.to(torch.float32)).to(torch.int64)
    pos = torch.where(cnt > nsample, strided, k).clamp(0, N - 1)
    idx = torch.gather(order, -1, pos).to(torch.int32)
    dist2 = torch.gather(d2_sorted, -1, pos)
    invalid = (cnt <= nsample) & (k >= cnt)
    return torch.where(invalid, -1, idx), torch.where(invalid, _BIG, dist2)


def uniform_priority(generator: Optional[torch.Generator], shape: tuple,
                     device) -> torch.Tensor:
    """The random ball query's priorities: U[0, 1) f32 of ``shape`` from
    ``generator`` (on ``device``)."""
    return torch.rand(shape, generator=generator, device=device)


def random_ball_query_padded(generator: Optional[torch.Generator], new_xyz: torch.Tensor,
                             xyz: torch.Tensor, mask: torch.Tensor, nsample: int,
                             max_radius: float, min_radius: float = 0.0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ball query whose candidates are taken in the order of one uniform
    priority a cloud (B, 1, N) instead of by distance; the first
    ``nsample`` (fewer where N is smaller), -1 / 1e10 past the candidates."""
    B, M, _ = new_xyz.shape
    N = xyz.shape[1]
    d2 = _sqdist(new_xyz, xyz)
    in_range = _in_ball(d2, mask, max_radius, min_radius)
    prio = uniform_priority(generator, (B, 1, N), d2.device).expand(B, M, N)
    order = torch.argsort(torch.where(in_range, prio, 2.0), dim=-1, stable=True)
    take = order[..., :nsample]
    taken_ok = torch.gather(in_range, -1, take)
    dist2 = torch.gather(d2, -1, take)
    return (torch.where(taken_ok, take, -1).to(torch.int32),
            torch.where(taken_ok, dist2, _BIG))


def grouping_padded(idx: torch.Tensor, feat: torch.Tensor, xyz: Optional[torch.Tensor] = None,
                    new_xyz: Optional[torch.Tensor] = None, with_xyz: bool = False
                    ) -> torch.Tensor:
    """Neighbourhoods (B, M, K) of ``feat`` (B, N, C) -> (B, M, K, C), a
    hole (-1) zero; ``with_xyz`` prepends ``xyz[nn] - new_xyz`` (zero at a
    hole)."""
    hole = (idx < 0)[..., None]
    gf = torch.where(hole, 0.0, gather_rows_padded(feat, idx)).to(feat.dtype)
    if not with_xyz:
        return gf
    gx = gather_rows_padded(xyz, idx) - new_xyz[:, :, None, :]
    gx = torch.where(hole, 0.0, gx).to(xyz.dtype)
    return torch.cat([gx, gf], dim=-1)


def subtraction_padded(input1: torch.Tensor, input2: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, N, C), (B, N, K) -> (B, N, K, C):
    ``input1[i] - input2[idx[i, k]]`` (a hole reads row 0)."""
    return input1[:, :, None, :] - gather_rows_padded(input2, idx)


def aggregation_padded(input: torch.Tensor, position: torch.Tensor, weight: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i, c] = sum_k (input[b, idx[b, i, k], c] + position[b, i, k, c])
    * weight[b, i, k, c mod w_c]`` (a hole reads row 0)."""
    C = position.shape[-1]
    w = weight.repeat(1, 1, 1, C // weight.shape[-1])
    return ((gather_rows_padded(input, idx) + position) * w).sum(dim=2)


def interpolation_padded(xyz: torch.Tensor, new_xyz: torch.Tensor, feat: torch.Tensor,
                         mask: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance weighting over the k nearest valid points (the kNN
    kernel on the card): weights ``1 / (dist + 1e-8)`` normalised over the
    k, ``dist`` euclidean."""
    idx, dist2 = knn_query_padded(new_xyz, xyz, mask, k)
    recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
    weight = recip / recip.sum(dim=-1, keepdim=True)
    return (grouping_padded(idx, feat) * weight[..., None]).sum(dim=2)


def knn_query_and_group_padded(feat: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor,
                               new_xyz: torch.Tensor, nsample: int, with_xyz: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN (:func:`knn_query_padded`) then :func:`grouping_padded`; -> the
    groups and the indices."""
    idx, _ = knn_query_padded(new_xyz, xyz, mask, nsample)
    return grouping_padded(idx, feat, xyz, new_xyz, with_xyz=with_xyz), idx


def attention_relation_step(query: torch.Tensor, key: torch.Tensor, weight: torch.Tensor,
                            index_target: torch.Tensor, index_refer: torch.Tensor
                            ) -> torch.Tensor:
    """``relation[e, g] = sum_c q[tgt[e], g, c] * k[ref[e], g, c] * w[c]``."""
    q = query[index_target.long()]
    k = key[index_refer.long()]
    return (q * k * weight[None, None, :]).sum(dim=-1)


def _segment_sum(values: torch.Tensor, segment: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s] = sum of values[e] with segment[e] == s`` over (n, ...):
    the edges sorted stably by segment, each run summed by a segmented
    suffix scan of doubling passes (its sum lands on its first slot), the
    runs' sums written once each. No atomics, so the same on every run."""
    m = values.shape[0]
    out = values.new_zeros((n,) + values.shape[1:])
    if m == 0:
        return out
    key, order = torch.sort(segment.long(), stable=True)
    acc = values[order]
    d = 1
    while d < m:
        same = (key[d:] == key[:-d]).reshape((-1,) + (1,) * (values.ndim - 1))
        acc = torch.cat([acc[:-d] + torch.where(same, acc[d:], 0.0), acc[-d:]])
        d <<= 1
    first = torch.ones(m, dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    return out.index_copy_(0, key[first], acc[first])


def attention_fusion_step(weight: torch.Tensor, value: torch.Tensor,
                          index_target: torch.Tensor, index_refer: torch.Tensor
                          ) -> torch.Tensor:
    """``out[n, g, c] = sum over edges e with tgt[e] == n of
    w[e, g] * v[ref[e], g, c]``, (value's shape): a deterministic segment
    sum, where the reference adds atomically."""
    contrib = weight[:, :, None] * value[index_refer.long()]
    return _segment_sum(contrib, index_target, value.shape[0]).to(value.dtype)


# ---------------------------------------------------------------------------
# packed clouds: offsets and the reference's signatures
# ---------------------------------------------------------------------------

def _as_tensor(x, device=None) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=device)


def offset2bincount(offset) -> torch.Tensor:
    """(b,) prefix sums -> (b,) counts."""
    offset = _as_tensor(offset)
    return torch.diff(offset, prepend=offset.new_zeros(1))


def offset2batch(offset) -> torch.Tensor:
    """(b,) prefix sums -> (n,) batch ids (int64)."""
    counts = offset2bincount(offset)
    return torch.repeat_interleave(torch.arange(len(counts), device=counts.device),
                                   counts.long())


def batch2offset(batch) -> torch.Tensor:
    """(n,) batch ids -> (b,) prefix sums (int32)."""
    return torch.cumsum(torch.bincount(_as_tensor(batch).long()), 0).to(torch.int32)


def _pack_to_padded(x: torch.Tensor, offset) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, ...) packed rows, (b,) offsets -> (b, n_max, ...) zero-padded
    rows and their (b, n_max) validity."""
    counts = offset2bincount(_as_tensor(offset, x.device)).long()
    b, n_max = len(counts), int(counts.max())
    batch = torch.repeat_interleave(torch.arange(b, device=x.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(x.shape[0], device=x.device) - starts[batch]
    out = x.new_zeros((b, n_max) + x.shape[1:])
    out[batch, slot] = x
    mask = torch.zeros((b, n_max), dtype=torch.bool, device=x.device)
    mask[batch, slot] = True
    return out, mask


def _unpack(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(b, m_max, ...) -> the first ``counts[i]`` rows of each, concatenated."""
    keep = torch.arange(rows.shape[1], device=rows.device)[None, :] < counts[:, None]
    return rows[keep]


def farthest_point_sampling(xyz, offset, new_offset) -> torch.Tensor:
    """Packed FPS, (n, 3), (b,), (b,) -> (m,) int32 indices into the n
    points (each cloud's FPS, the kernel on the card)."""
    xyz = _as_tensor(xyz).to(torch.float32)
    offset, new_offset = _as_tensor(offset, xyz.device), _as_tensor(new_offset, xyz.device)
    xyz_p, mask = _pack_to_padded(xyz, offset)
    new_counts = offset2bincount(new_offset).long()
    idx = farthest_point_sampling_padded(xyz_p, mask, int(new_counts.max()))
    starts = (torch.cumsum(offset2bincount(offset).long(), 0)
              - offset2bincount(offset).long())
    return _unpack(idx.long() + starts[:, None], new_counts).to(torch.int32)


def _packed_query(fn: Callable, nsample: int, xyz, offset, new_xyz, new_offset
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A padded query ``fn(queries, points, mask, nsample)`` over packed
    clouds; the indices back into the packed points (-1 kept)."""
    xyz = _as_tensor(xyz).to(torch.float32)
    if new_xyz is None or new_offset is None:
        new_xyz, new_offset = xyz, offset
    new_xyz = _as_tensor(new_xyz, xyz.device).to(torch.float32)
    offset, new_offset = _as_tensor(offset, xyz.device), _as_tensor(new_offset, xyz.device)
    xyz_p, mask = _pack_to_padded(xyz, offset)
    q_p, _ = _pack_to_padded(new_xyz, new_offset)
    idx_p, dist2_p = fn(q_p, xyz_p, mask, nsample)
    counts = offset2bincount(offset).long()
    starts = torch.cumsum(counts, 0) - counts
    idx_p = torch.where(idx_p >= 0, idx_p.long() + starts[:, None, None], -1)
    new_counts = offset2bincount(new_offset).long()
    return _unpack(idx_p, new_counts).to(torch.int32), _unpack(dist2_p, new_counts)


def knn_query(nsample: int, xyz, offset, new_xyz=None, new_offset=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, k) int32 indices and euclidean distances of each query's k
    nearest points of its cloud (the kNN kernels on the card)."""
    idx, dist2 = _packed_query(knn_query_padded, nsample, xyz, offset, new_xyz, new_offset)
    return idx, torch.sqrt(dist2)


def ball_query(nsample: int, max_radius: float, min_radius: float, xyz, offset,
               new_xyz=None, new_offset=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed :func:`ball_query_padded`; euclidean distances."""
    assert min_radius < max_radius
    idx, dist2 = _packed_query(
        lambda q, x, m, k: ball_query_padded(q, x, m, k, max_radius, min_radius),
        nsample, xyz, offset, new_xyz, new_offset)
    return idx, torch.sqrt(dist2)


def random_ball_query(nsample: int, max_radius: float, min_radius: float, xyz, offset,
                      new_xyz=None, new_offset=None,
                      generator: Optional[torch.Generator] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed :func:`random_ball_query_padded`; euclidean distances. Without
    a generator one is seeded from numpy's global stream, as JAX draws its
    key."""
    assert min_radius < max_radius
    if generator is None:
        device = _as_tensor(xyz).device
        generator = torch.Generator(device=device).manual_seed(
            int(np.random.randint(0, 2 ** 31 - 1)))
    idx, dist2 = _packed_query(
        lambda q, x, m, k: random_ball_query_padded(generator, q, x, m, k, max_radius,
                                                    min_radius),
        nsample, xyz, offset, new_xyz, new_offset)
    return idx, torch.sqrt(dist2)


def grouping(idx, feat, xyz, new_xyz=None, with_xyz: bool = False) -> torch.Tensor:
    """Packed gather (m, k) of (n, c) -> (m, k, c), a hole (-1) zero;
    ``with_xyz`` prepends ``xyz[nn] - new_xyz``."""
    feat = _as_tensor(feat)
    idx, xyz = _as_tensor(idx, feat.device).long(), _as_tensor(xyz, feat.device)
    new_xyz = xyz if new_xyz is None else _as_tensor(new_xyz, feat.device)
    hole = (idx < 0)[..., None]
    safe = idx.clamp_min(0)
    grouped = torch.where(hole, 0.0, feat[safe]).to(feat.dtype)
    if not with_xyz:
        return grouped
    gx = torch.where(hole, 0.0, xyz[safe] - new_xyz[:, None, :]).to(xyz.dtype)
    return torch.cat([gx, grouped], dim=-1)


def grouping2(input, idx) -> torch.Tensor:
    """(n, c), (m, k) -> (m, k, c); a hole reads row 0."""
    input = _as_tensor(input)
    return input[_as_tensor(idx, input.device).long().clamp_min(0)]


def interpolation(xyz, new_xyz, feat, offset, new_offset, k: int = 3) -> torch.Tensor:
    """Packed inverse-distance interpolation of ``feat`` onto ``new_xyz``
    from each query's k nearest points (the kNN kernels on the card)."""
    idx, dist = knn_query(k, xyz, offset, new_xyz, new_offset)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=1, keepdim=True)
    feat = _as_tensor(feat, idx.device)
    return (feat[idx.long().clamp_min(0)] * weight[..., None]).sum(dim=1).to(feat.dtype)


interpolation2 = interpolation


def subtraction(input1, input2, idx) -> torch.Tensor:
    """(n, c), (n, c), (n, k) -> (n, k, c): ``input1[i] - input2[idx[i, k]]``."""
    input1 = _as_tensor(input1)
    input2, idx = _as_tensor(input2, input1.device), _as_tensor(idx, input1.device)
    return input1[:, None, :] - input2[idx.long().clamp_min(0)]


def aggregation(input, position, weight, idx) -> torch.Tensor:
    """(n, c), (n, k, c), (n, k, w_c), (n, k) -> (n, c)."""
    input = _as_tensor(input)
    position = _as_tensor(position, input.device)
    weight, idx = _as_tensor(weight, input.device), _as_tensor(idx, input.device)
    c = position.shape[-1]
    w = weight.repeat(1, 1, c // weight.shape[-1])
    return ((input[idx.long().clamp_min(0)] + position) * w).sum(dim=1)


def knn_query_and_group(feat, xyz, offset=None, new_xyz=None, new_offset=None, idx=None,
                        nsample: Optional[int] = None, with_xyz: bool = False):
    """kNN (unless ``idx`` is given) then :func:`grouping`; -> (groups, idx)."""
    if idx is None:
        assert nsample is not None
        idx, _ = knn_query(nsample, xyz, offset, new_xyz, new_offset)
    return grouping(idx, feat, xyz, new_xyz, with_xyz), idx


def ball_query_and_group(feat, xyz, offset=None, new_xyz=None, new_offset=None, idx=None,
                         max_radio: Optional[float] = None, min_radio: float = 0,
                         nsample: Optional[int] = None, with_xyz: bool = False):
    """Ball query (unless ``idx`` is given) then :func:`grouping`."""
    if idx is None:
        assert nsample is not None and offset is not None
        assert max_radio is not None and min_radio is not None
        idx, _ = ball_query(nsample, max_radio, min_radio, xyz, offset, new_xyz, new_offset)
    return grouping(idx, feat, xyz, new_xyz, with_xyz), idx


def query_and_group(nsample: int, xyz, new_xyz, feat, idx, offset, new_offset,
                    dilation: int = 0, with_feat: bool = True, with_xyz: bool = True):
    """Dilated kNN and grouping: ``1 + (nsample - 1) * (dilation + 1)``
    neighbours, every ``dilation + 1``-th kept (a cloud with fewer points
    spreads the ``nsample`` over what it has), then the relative
    coordinates and the features."""
    xyz = _as_tensor(xyz)
    new_xyz = xyz if new_xyz is None else _as_tensor(new_xyz, xyz.device)
    if idx is None:
        num_total = 1 + (nsample - 1) * (dilation + 1)
        idx_full, _ = knn_query(num_total, xyz, offset, new_xyz, new_offset)
        ends = [int(v) for v in _as_tensor(offset).tolist()]
        nb_ends = [int(v) for v in _as_tensor(new_offset).tolist()]
        rows = []
        for i, (start, end) in enumerate(zip([0] + ends[:-1], ends)):
            seg = end - start
            soft = (seg - 1) / (nsample - 1) - 1 if seg < num_total else dilation
            cols = [int((soft + 1) * j) for j in range(nsample)]
            nb_start = 0 if i == 0 else nb_ends[i - 1]
            rows.append(idx_full[nb_start:nb_ends[i]][:, cols])
        idx = torch.cat(rows, dim=0)
    if not with_feat:
        return idx
    feat = _as_tensor(feat, xyz.device)
    safe = _as_tensor(idx, xyz.device).long().clamp_min(0)
    grouped_xyz = xyz[safe] - new_xyz[:, None, :]
    grouped_feat = feat[safe]
    if with_xyz:
        return torch.cat([grouped_xyz, grouped_feat], dim=-1), idx
    return grouped_feat, idx
