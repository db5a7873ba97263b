"""Sparse-voxel primitives of SpUNet (port of
``pointcloudmatters_tpu/ops/sparse.py``): plain PyTorch on padded batches.

The JAX package computes these in XLA, not in Pallas, so they have no CUDA
kernel of their own: sorts, binary searches, gathers and matrix products.
The semantics are the JAX functions', slot for slot:

- voxel coordinates are linearized to int32 keys (``< 1024`` an axis; an
  invalid or out-of-range voxel is ``INT32_MAX``, which sorts to the tail)
  and sorted once a lookup with a stable sort; a neighbour is found by
  ``searchsorted`` over each batch row, ``-1`` where it is missing;
- a submanifold convolution is ``sum_k feat[idx[:, :, k]] @ W[k]``, one
  product of the stacked ``(B, N, K * Ci)`` gather, accumulated in f32 and
  rounded once to the features' type;
- the stride-2 convolution adds each point's ``feat @ W[tap]`` onto the
  representative slot of its parent voxel (the first child in stable sorted
  order, which is the child of least index); the inverse convolution reads
  the parent's features back through the child's tap. The padded length N
  is the same at every level; only the valid mask shrinks.

Determinism (no float atomics anywhere, so two runs on the card are
bit-equal): the sums over a parent's children run over the contiguous run
of the children in sorted order, by a segmented suffix scan
(:func:`_group_sums`; a tree of adds, at most ``ceil(log2(max_children))``
passes). :func:`submconv` is an autograd function that saves only its
inputs: its backward recomputes the gathers for ``dW`` and computes
``dfeat`` as a gather, not a scatter. Where the valid voxels' coordinates
are unique (grid sampling makes them so, and every level above the input
is unique by construction), the submanifold map is symmetric: ``idx[n, k]
== m`` iff ``idx[m, K - 1 - k] == n``, so ``dfeat = submconv(dout,
W[::-1]^T, idx)``. Where a coordinate repeats, the forward reads only its
first slot; the backward then first sums ``dout`` over each coordinate's
slots onto that first slot (the same segmented scan, ``ceil(log2 N)``
passes) and gives the other slots zero, which is the gradient of the
forward, duplicates included. ``max_dup=1`` (a level known to be unique)
skips that sum.

Coordinates must lie in ``[0, 1024)``: a valid point outside has no key,
as in JAX, and its gradient is not defined by the symmetric map.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["kernel_offsets", "kernel_offsets_on", "linearize", "neighbor_indices",
           "gather_neighbors", "submconv", "voxel_downsample", "strided_downconv",
           "inverse_upconv", "INVALID"]

_S = 1024  # per-axis coordinate bound of the keys
INVALID = 2**31 - 1


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """(K, 3) integer offsets of a centred cubic kernel, row-major (the
    order of spconv's weight planes); ``offsets[K - 1 - k] == -offsets[k]``."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def kernel_offsets_on(kernel_size: int, device) -> torch.Tensor:
    """:func:`kernel_offsets` as an int32 tensor made on ``device`` (no copy
    from the host, so no synchronisation with the card)."""
    r = torch.arange(kernel_size, dtype=torch.int32, device=device) - (kernel_size - 1) // 2
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def linearize(grid_coord: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int coordinates -> (...) int32 keys; invalid or out of range
    -> ``INVALID``."""
    gc = grid_coord.to(torch.int32)
    in_range = ((gc >= 0) & (gc < _S)).all(dim=-1)
    key = (gc[..., 0] * _S + gc[..., 1]) * _S + gc[..., 2]
    return torch.where(valid & in_range, key, INVALID)


def neighbor_indices(grid_coord: torch.Tensor, valid: torch.Tensor, offsets) -> torch.Tensor:
    """For each point and kernel offset (``offsets`` (K, 3), numpy or a
    tensor on the coordinates' device), the index of the neighbour voxel in
    the same batch row (the first slot holding it), or -1: (B, N, K) int32."""
    B, N = valid.shape
    key = linearize(grid_coord, valid)
    sorted_key, order = torch.sort(key, dim=-1, stable=True)
    off = offsets if torch.is_tensor(offsets) else torch.from_numpy(
        np.asarray(offsets, np.int32)).to(grid_coord.device)
    q_coord = grid_coord.to(torch.int32)[:, :, None, :] + off  # (B, N, K, 3)
    q_key = linearize(q_coord, valid[:, :, None]).reshape(B, -1)
    pos = torch.searchsorted(sorted_key, q_key).clamp_(max=N - 1)
    found = (torch.gather(sorted_key, 1, pos) == q_key) & (q_key != INVALID)
    idx = torch.where(found, torch.gather(order, 1, pos), -1)
    return idx.reshape(B, N, -1).to(torch.int32)


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N, K) indices into rows of length n, -1 = none -> flat int64
    indices into the (B * (n + 1)) rows of :func:`_padded_rows`, -1 -> the
    row's zero row."""
    B = idx.shape[0]
    base = torch.arange(B, device=idx.device, dtype=torch.int64)[:, None, None] * (n + 1)
    local = torch.where(idx < 0, n, idx.to(torch.int64))
    return (base + local).reshape(-1)


def _padded_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B * (N + 1), C): each batch row with a zero row after it."""
    B, N, C = x.shape
    return torch.cat([x, x.new_zeros(B, 1, C)], dim=1).reshape(B * (N + 1), C)


def gather_neighbors(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, N, K) -> (B, N, K, C); -1 -> zeros."""
    B, N, K = idx.shape
    rows = _padded_rows(feat).index_select(0, _flat_index(idx, feat.shape[1]))
    return rows.reshape(B, N, K, feat.shape[-1])


def _stacked_product(feat: torch.Tensor, weight: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """``gather (B, N, K * Ci) @ W (K * Ci, Co)``, in the features' type."""
    B, N, K = idx.shape
    gathered = gather_neighbors(feat, idx).reshape(B, N, K * feat.shape[-1])
    return torch.matmul(gathered, weight.reshape(-1, weight.shape[-1]).to(feat.dtype))


def _group_sums(x: torch.Tensor, key: torch.Tensor, max_run: int) -> torch.Tensor:
    """Each group's sum at the group's first slot.

    ``key`` (B, N) int groups the rows of ``x`` (B, N, C); ``INVALID``
    rows are left out of every sum that lands on a valid key. In stable
    sorted order a group is a contiguous run starting at its least index; a
    segmented suffix scan of ``ceil(log2(max_run))`` doubling passes (no
    atomics: deterministic) leaves the run's sum at its first position.
    Returns (B, N, C) with the sums at the groups' first slots and partial
    sums elsewhere."""
    N = x.shape[1]
    if max_run <= 1 or N == 1:
        return x
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    perm = order[..., None].expand_as(x)
    acc = torch.gather(x, 1, perm)
    for p in range(math.ceil(math.log2(min(max_run, N)))):
        d = 1 << p
        same = ((sorted_key[:, d:] == sorted_key[:, :-d])
                & (sorted_key[:, d:] != INVALID))[..., None]
        acc = torch.cat([acc[:, :-d] + torch.where(same, acc[:, d:], 0.0), acc[:, -d:]], dim=1)
    return torch.zeros_like(acc).scatter(1, perm, acc)


class _SubmConv(torch.autograd.Function):
    """Submanifold convolution that saves only its inputs (module doc)."""

    @staticmethod
    def forward(ctx, feat, weight, idx, max_dup):
        ctx.save_for_backward(feat, weight, idx)
        ctx.max_dup = max_dup
        return _stacked_product(feat, weight, idx)

    @staticmethod
    def backward(ctx, dout):
        feat, weight, idx = ctx.saved_tensors
        B, N, K = idx.shape
        dfeat = dweight = None
        if ctx.needs_input_grad[1]:
            gathered = gather_neighbors(feat, idx).reshape(B * N, -1)
            dweight = torch.matmul(gathered.t(), dout.reshape(B * N, -1).to(feat.dtype))
            dweight = dweight.reshape(weight.shape).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            w_t = weight.flip(0).transpose(1, 2)  # W[K - 1 - k]^T
            if ctx.max_dup == 1:
                dfeat = _stacked_product(dout, w_t, idx)
            else:
                # sum dout over each coordinate's slots onto its first slot
                # (canon = the centre tap's lookup), zero on the others
                canon = idx[:, :, (K - 1) // 2]
                key = torch.where(canon >= 0, canon, INVALID)
                summed = _group_sums(dout, key, ctx.max_dup)
                dfeat = _stacked_product(summed, w_t, idx)
                first = canon == torch.arange(N, device=idx.device, dtype=canon.dtype)
                dfeat = torch.where(first[..., None], dfeat, 0.0)
            dfeat = dfeat.to(feat.dtype)
        return dfeat, dweight, None, None


def submconv(feat: torch.Tensor, weight: torch.Tensor, idx: torch.Tensor,
             max_dup: Optional[int] = None) -> torch.Tensor:
    """Submanifold sparse convolution.

    feat (B, N, Ci), weight (K, Ci, Co) (a plane a kernel offset), idx
    (B, N, K) from :func:`neighbor_indices` -> (B, N, Co). ``max_dup``
    bounds how many valid slots share a coordinate (None: N); 1 makes the
    backward the plain symmetric gather (module doc)."""
    return _SubmConv.apply(feat, weight, idx, feat.shape[1] if max_dup is None else max_dup)


def voxel_downsample(grid_coord: torch.Tensor, valid: torch.Tensor):
    """Stride-2 voxel pooling bookkeeping.

    Returns ``parent_coord`` (B, N, 3) ``grid_coord // 2`` (0 where
    invalid), ``rep`` (B, N) int32, the index of the representative slot of
    each point's parent voxel (its first child in stable sorted order), -1
    for invalid points, and ``new_valid`` (B, N), True only at the
    representative slots."""
    parent = torch.where(valid[..., None], torch.div(grid_coord, 2, rounding_mode="floor"), 0)
    key = linearize(parent, valid)
    N = key.shape[1]
    sorted_key, order = torch.sort(key, dim=-1, stable=True)
    prev = torch.cat([torch.full_like(sorted_key[:, :1], -1), sorted_key[:, :-1]], dim=1)
    is_first = sorted_key != prev
    pos = torch.arange(N, device=key.device)[None, :]
    group_first = torch.cummax(torch.where(is_first, pos, 0), dim=1).values
    rep_sorted = torch.gather(order, 1, group_first)
    rep = torch.zeros_like(rep_sorted).scatter(1, order, rep_sorted)
    rep = torch.where(valid, rep, -1).to(torch.int32)
    new_valid = torch.zeros_like(valid).scatter(1, order, is_first & (sorted_key != INVALID))
    return parent, rep, new_valid


def _tap(grid_coord: torch.Tensor) -> torch.Tensor:
    """(B, N) 0..7: the position in the 2x2x2 window, binary (x, y, z)."""
    local = grid_coord.to(torch.int32) & 1
    return ((local[..., 0] * 2 + local[..., 1]) * 2 + local[..., 2]).to(torch.int64)


def _tap_product(x: torch.Tensor, weight: torch.Tensor, tap: torch.Tensor) -> torch.Tensor:
    """``x[b, n] @ W[tap[b, n]]``: (B, N, Ci), (8, Ci, Co) -> (B, N, Co),
    accumulated in f32 and rounded once (all 8 products, then the tap's)."""
    B, N, _ = x.shape
    Co = weight.shape[-1]
    w_all = weight.to(x.dtype).permute(1, 0, 2).reshape(weight.shape[1], 8 * Co)
    every = torch.matmul(x, w_all).reshape(B, N, 8, Co)
    return torch.gather(every, 2, tap[:, :, None, None].expand(B, N, 1, Co))[:, :, 0]


def _children_key(rep: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, rep, INVALID)


def _is_rep(rep: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return valid & (rep == torch.arange(rep.shape[1], device=rep.device, dtype=rep.dtype))


def strided_downconv(feat: torch.Tensor, weight: torch.Tensor, grid_coord: torch.Tensor,
                     rep: torch.Tensor, valid: torch.Tensor,
                     max_children: Optional[int] = None) -> torch.Tensor:
    """Stride-2 sparse convolution: each valid point's ``feat @ W[tap]``
    summed onto its parent's representative slot (zeros elsewhere), by
    :func:`_group_sums` over the children's run. weight (8, Ci, Co), tap
    order binary (x, y, z) low bits. ``max_children`` bounds the children a
    parent has (None: N; 8 where the coordinates are unique)."""
    contrib = _tap_product(feat, weight, _tap(grid_coord))
    contrib = torch.where(valid[..., None], contrib, 0.0)
    bound = feat.shape[1] if max_children is None else max_children
    sums = _group_sums(contrib, _children_key(rep, valid), bound)
    return torch.where(_is_rep(rep, valid)[..., None], sums, 0.0)


class _GatherParent(torch.autograd.Function):
    """``x[rep]`` at valid points (zeros elsewhere); its backward sums the
    children's gradients onto the representative by :func:`_group_sums`
    instead of scattering them."""

    @staticmethod
    def forward(ctx, x, rep, valid, max_children):
        ctx.save_for_backward(rep, valid)
        ctx.max_children = max_children
        safe = rep.clamp_min(0).to(torch.int64)[..., None].expand(-1, -1, x.shape[-1])
        return torch.where(valid[..., None], torch.gather(x, 1, safe), 0.0)

    @staticmethod
    def backward(ctx, grad):
        rep, valid = ctx.saved_tensors
        grad = torch.where(valid[..., None], grad, 0.0)
        sums = _group_sums(grad, _children_key(rep, valid), ctx.max_children)
        return torch.where(_is_rep(rep, valid)[..., None], sums, 0.0), None, None, None


def inverse_upconv(parent_feat: torch.Tensor, weight: torch.Tensor, grid_coord: torch.Tensor,
                   rep: torch.Tensor, valid: torch.Tensor,
                   max_children: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`strided_downconv` (spconv's ``SparseInverseConv3d``):
    each valid child reads its parent's features (on the representative
    slot) through its tap's plane. weight (8, Ci, Co); ``max_children`` as
    in :func:`strided_downconv`, for the backward's sums."""
    bound = parent_feat.shape[1] if max_children is None else max_children
    gathered = _GatherParent.apply(parent_feat, rep, valid, bound)
    return _tap_product(gathered, weight, _tap(grid_coord))
