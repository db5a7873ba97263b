"""Point-cloud primitives over padded batches (port of
``pointcloudmatters_tpu/ops/pointops.py:80-322, 416-443, 531``).

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
hand-written kernel (``ops/fps.py``, ``ops/knn.py``, ``ops/knn_chunkskip.py``,
``ops/knn_baseline.py``), which raises on anything it does not take.
:func:`knn_query_padded` picks its kNN backend as JAX does, from
``PCM_KNN_IMPL`` (:func:`knn_route`).
"""

from __future__ import annotations

import os

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
