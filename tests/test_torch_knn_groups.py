"""The lane-group selection of the exact kNN kernels 2 (``csrc/knn.cu``), 12
(``csrc/knn_chunkskip.cu``) and 13 (``csrc/knn_baseline.cu``), all on
``csrc/knn_select.cuh``, on the CPU.

A numpy emulation of each kernel's selection is held index for index, with
d2 bit-equal, against the port's plain versions and JAX's kNN:

- kernel 2: queries in groups of S lanes (32 / S a warp); the cloud's
  records (x, y, z, |p|^2; invalid points (0, 0, 0, +inf)) in the kernel's
  visiting order (position j holds point j A mod N) and in 1024-point
  tiles padded with invalid records; lane r of a group takes the tile's
  points r, r + S, ..., four between two votes; a lane queues a point that
  comes before its row's k-th pair (refreshed at each merge) in a queue of
  8; before every four points, the warp merges every queue of its groups
  into their lists when any lane holds more than 4, and once at the end.
  A merge keeps the S R smallest (distance, index) pairs of the list and the
  queues (the kernel's bitonic network or insertion computes that set);
- kernel 12: the same selection in the TPU's traversal (512-point chunks,
  the ring order from the tile's home chunk) over tiles of TQ queries, far
  chunks pruned by their boxes (``box_bound``), the queues merged at the end
  of every computed chunk, and the skip test on the tile's k-th snapshot;
- kernel 13: the same selection over tiles of TQ queries in the TPU's
  dense-scan traversal (2048-point chunks in index order, none skipped,
  each padded with invalid records to the lanes' step), the queues merged
  by the votes and once at the end.

The distances are ``pcm_topk::dist2`` in numpy float32, one rounding an
operation in the kernel's order. Cases: every S, k in {1, 4, 16, 33, 128}
(kernel 13: {1, 16, 33, 128}),
lattice clouds full of exact ties, invalid points with inf and NaN
coordinates, a row with fewer valid points than k, N divisible by neither
S nor the tile. The box bound is checked against every ``dist2`` value of
its boxes, far from the origin too. The choosers are checked against their
rules on a model of an H100 (132 SMs), and the C entries against the
wrappers' ctypes argtypes and constants. The kernels themselves run on the
card only (``chip_smoke.py`` phase 3 holds them index-exact against the
plain versions there).
"""

import ctypes
import functools
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pointcloudmatters_tpu.ops import pallas_knn as jknn
from pointcloudmatters_tpu.ops import pallas_knn3 as jknn3
from pointcloudmatters_tpu.ops import pointops as jops
from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import knn as tkn
from pointcloudmatters_tpu_torch.ops import knn_baseline as tkb
from pointcloudmatters_tpu_torch.ops import knn_chunkskip as tkc
from pointcloudmatters_tpu_torch.ops import pointops as tpo

CSRC = _build.CSRC
BIG = np.float32(1e10)
NO_INDEX = np.int64(2**31 - 1)
QUEUE, UNROLL, TILE = 8, 4, 1024  # csrc/knn_select.cuh kQueue, kUnroll; knn.cu kTile
MARGIN = np.float32(2.0**-18)     # knn_select.cuh kMargin
H100_SMS = 132


def _consts(name: str) -> dict:
    with open(os.path.join(CSRC, name)) as f:
        return {k: v for k, v in re.findall(r"constexpr (?:int|float) (k\w+) = ([^;]+);", f.read())}


def _records(xyz, mask):
    """(B, N, 4) f32 records: (x, y, z, |p|^2), (0, 0, 0, +inf) if invalid."""
    x, y, z = (xyz[..., a].astype(np.float32) for a in range(3))
    rec = np.zeros(xyz.shape[:2] + (4,), np.float32)
    rec[..., 0], rec[..., 1], rec[..., 2] = (np.where(mask, v, np.float32(0)) for v in (x, y, z))
    with np.errstate(invalid="ignore", over="ignore"):
        rec[..., 3] = np.where(mask, (x * x + y * y) + z * z, np.float32(np.inf))
    return rec


def _dist2(q, q2, r):
    """pcm_topk::dist2 of queries (..., 3) with norms q2 and records r (..., 4)."""
    dot = (q[..., 0] * r[..., 0] + q[..., 1] * r[..., 1]) + q[..., 2] * r[..., 2]
    return np.fmax((q2 + r[..., 3]) - np.float32(2) * dot, np.float32(0))


def _before(d, i, td, ti):
    return (d < td) | ((d == td) & (i < ti))


class _Selection:
    """The lists, queues and thresholds of ``rows`` queries in groups of S
    lanes (32 / S rows a warp), L = S * list_rows(k, S) slots a list."""

    def __init__(self, rows, active, k, S, stats):
        self.k, self.S, self.stats = k, S, stats
        self.L = S * max(1, (1 << (k - 1).bit_length()) // S)
        self.active = active
        self.ld = np.full((rows, self.L), BIG, np.float32)
        self.li = np.full((rows, self.L), NO_INDEX, np.int64)
        self.qd = np.full((rows, S, QUEUE), np.inf, np.float32)
        self.qi = np.full((rows, S, QUEUE), NO_INDEX, np.int64)
        self.cnt = np.zeros((rows, S), np.int64)
        self.warp = np.arange(rows) // (32 // S)
        self.td = np.where(active, BIG, -np.inf).astype(np.float32)
        self.ti = np.where(active, NO_INDEX, -1)

    def _warps_where(self, lane_flag):
        """Rows whose warp has a lane with ``lane_flag``."""
        per_warp = np.zeros(self.warp[-1] + 1, bool)
        np.logical_or.at(per_warp, self.warp, lane_flag.any(1))
        return per_warp[self.warp]

    def vote(self, rows=None):
        """Merge the warps (of ``rows``) where a lane holds more than
        QUEUE - UNROLL pairs."""
        flag = self.cnt > QUEUE - UNROLL
        if rows is not None:
            flag &= rows[:, None]
        self.merge(self._warps_where(flag))

    def merge(self, sel):
        if not sel.any():
            return
        self.stats["merges"] += len(np.unique(self.warp[sel]))
        n = int(sel.sum())
        d = np.concatenate([self.ld[sel], self.qd[sel].reshape(n, -1)], 1)
        i = np.concatenate([self.li[sel], self.qi[sel].reshape(n, -1)], 1)
        order = np.lexsort((i, d), axis=-1)[:, :self.L]
        self.ld[sel] = np.take_along_axis(d, order, 1)
        self.li[sel] = np.take_along_axis(i, order, 1)
        self.qd[sel], self.qi[sel], self.cnt[sel] = np.inf, NO_INDEX, 0
        self.td[sel] = np.where(self.active[sel], self.ld[sel, self.k - 1], -np.inf)
        self.ti[sel] = np.where(self.active[sel], self.li[sel, self.k - 1], -1)

    def push(self, d, i):
        """(rows, S) distances and indices, one a lane."""
        take = _before(d, i, self.td[:, None], self.ti[:, None])
        r, l = np.nonzero(take)
        assert (self.cnt[r, l] < QUEUE).all()  # the vote keeps a queue from overflowing
        self.qd[r, l, self.cnt[r, l]] = d[r, l]
        self.qi[r, l, self.cnt[r, l]] = i[r, l]
        self.cnt[r, l] += 1
        self.stats["queued"] += len(r)

    def finish(self, rows=None):
        """Merge the warps (of ``rows``) where a lane holds a pair."""
        flag = self.cnt > 0
        if rows is not None:
            flag &= rows[:, None]
        self.merge(self._warps_where(flag))

    def result(self):
        d = self.ld[:, :self.k]
        return np.where(d >= BIG, -1, self.li[:, :self.k]).astype(np.int32), d


def _scan(sel, q, q2, rec, idx, rows_b, span, rows=None):
    """Every row takes the `span` records rec[b] (B, span, 4) with indices
    idx (B, span), lane r the points r, r + S, ..., UNROLL between two
    votes; returns each row's smallest distance."""
    S = sel.S
    rmin = np.full(q.shape[0], np.inf, np.float32)
    for s0 in range(0, span, S * UNROLL):
        sel.vote(rows)
        pos = s0 + np.arange(UNROLL)[:, None] * S + np.arange(S)[None]  # (UNROLL, S)
        r = rec[rows_b[:, None, None], pos.T[None]]  # (rows, S, UNROLL, 4)
        d = _dist2(q[:, None, None], q2[:, None, None], r)
        i = idx[rows_b[:, None, None], pos.T[None]]
        if rows is not None:  # rows of blocks that skip this chunk take nothing
            d = np.where(rows[:, None, None], d, np.float32(np.inf))
        rmin = np.minimum(rmin, d.min(axis=(1, 2)))
        for u in range(UNROLL):
            sel.push(d[..., u], i[..., u])
    return rmin


def _rows(q, block_rows, S):
    """Queries (B, M, 3) as rows of whole blocks: (rows, 3), their norms,
    batch, activity and the padded M."""
    B, M, _ = q.shape
    Mp = -(-M // block_rows) * block_rows
    qq = np.zeros((B, Mp, 3), np.float32)
    qq[:, :M] = q
    qq = qq.reshape(-1, 3)
    active = np.tile(np.arange(Mp) < M, B)
    q2 = (qq[:, 0] * qq[:, 0] + qq[:, 1] * qq[:, 1]) + qq[:, 2] * qq[:, 2]
    return qq, q2, np.repeat(np.arange(B), Mp), active, Mp


def emulate_dense(q, xyz, mask, k, S, stats=None):
    """Kernel 2's selection: (idx, d2) as the kernel returns them."""
    stats = {"merges": 0, "queued": 0} if stats is None else stats
    B, M, _ = q.shape
    N = xyz.shape[1]
    qq, q2, rows_b, active, Mp = _rows(q, tkn.THREADS // S, S)
    A = tkn.order_multiplier(N)
    order = (np.arange(N, dtype=np.int64) * A) % N  # position j holds point j A mod N
    rec, idx = _records(xyz, mask)[:, order], np.broadcast_to(order, (B, N))
    sel = _Selection(qq.shape[0], active, k, S, stats)
    for t0 in range(0, N, TILE):
        cnt = min(TILE, N - t0)
        span = -(-cnt // (S * UNROLL)) * (S * UNROLL)
        tile = np.zeros((B, span, 4), np.float32)
        tile[..., 3] = np.inf  # the padding: invalid records
        tile[:, :cnt] = rec[:, t0:t0 + cnt]
        tidx = np.full((B, span), NO_INDEX, np.int64)
        tidx[:, :cnt] = idx[:, t0:t0 + cnt]
        _scan(sel, qq, q2, tile, tidx, rows_b, span)
    sel.finish()
    i, d = sel.result()
    return i.reshape(B, Mp, k)[:, :M], d.reshape(B, Mp, k)[:, :M]


def box_bound(tbox, cbox):
    """knn_select.cuh ``box_bound`` in numpy float32: tbox (..., 7) the
    tiles' lows, highs and largest |q|^2, cbox (..., 8) the chunks' lows,
    highs, largest |p|^2 and valid points."""
    lb = np.zeros(np.broadcast_shapes(tbox.shape[:-1], cbox.shape[:-1]), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for a in range(3):
            gap = np.fmax(np.fmax(tbox[..., a] - cbox[..., 3 + a], cbox[..., a] - tbox[..., 3 + a]),
                          np.float32(0))
            lb = lb + gap * gap
        margin = MARGIN * ((lb + tbox[..., 6]) + cbox[..., 6])
        bound = np.fmin(lb - margin, BIG)
    return np.where(cbox[..., 7] == 0, BIG, bound).astype(np.float32)


def _chunk_boxes(rec, valid, tn):
    """(B, n_chunks, 8): each chunk's box of its valid points, as the
    pre-pass writes it."""
    B, N, _ = rec.shape
    n_chunks = -(-N // tn)
    pad = n_chunks * tn - N
    r = np.concatenate([rec, np.zeros((B, pad, 4), np.float32)], 1).reshape(B, n_chunks, tn, 4)
    v = np.concatenate([valid, np.zeros((B, pad), bool)], 1).reshape(B, n_chunks, tn)
    box = np.empty((B, n_chunks, 8), np.float32)
    for a in range(3):
        box[..., a] = np.where(v, r[..., a], np.inf).min(-1)
        box[..., 3 + a] = np.where(v, r[..., a], -np.inf).max(-1)
    box[..., 6] = np.where(v, r[..., 3], -np.inf).max(-1)
    box[..., 7] = v.sum(-1)
    return box


def emulate_chunkskip(q, xyz, mask, k, S, TQ, stats=None):
    """Kernel 12's selection at query tile TQ: (idx, d2, skipped, pruned)."""
    stats = {"merges": 0, "queued": 0} if stats is None else stats
    B, M, _ = q.shape
    N = xyz.shape[1]
    tn = min(512, max(N, 128))
    n_chunks = -(-N // tn)
    qq, q2, rows_b, active, Mp = _rows(q, TQ, S)
    n_tiles = Mp // TQ
    tile_of = np.arange(qq.shape[0]) // TQ  # (b, tile) blocks, row-major
    rec = _records(xyz, mask)
    boxes = _chunk_boxes(rec, mask, tn)
    span = -(-tn // (S * UNROLL)) * (S * UNROLL)
    chunk_rec = np.zeros((B, n_chunks, span, 4), np.float32)
    chunk_rec[..., 3] = np.inf
    chunk_idx = np.full((B, n_chunks, span), NO_INDEX, np.int64)
    for c in range(n_chunks):
        cnt = min(tn, N - c * tn)
        chunk_rec[:, c, :cnt] = rec[:, c * tn:c * tn + cnt]
        chunk_idx[:, c, :cnt] = np.arange(c * tn, c * tn + cnt)
    # the tiles' boxes of their active queries, and largest |q|^2
    a = active[:, None]
    lo = np.where(a, qq, np.inf).reshape(-1, TQ, 3).min(1)
    hi = np.where(a, qq, -np.inf).reshape(-1, TQ, 3).max(1)
    tq2 = np.where(active, q2, -np.inf).reshape(-1, TQ).max(1)
    tbox = np.concatenate([lo, hi, tq2[:, None]], 1).astype(np.float32)

    sel = _Selection(qq.shape[0], active, k, S, stats)
    blocks = B * n_tiles
    blk_b = np.repeat(np.arange(B), n_tiles)
    c0 = np.tile(np.arange(n_tiles) * n_chunks // n_tiles, B)
    tau = np.full(blocks, BIG, np.float32)
    skipped = pruned = 0
    for j in range(n_chunks):
        off = (j + 1) // 2
        c = (c0 + (off if j % 2 else -off) + n_chunks) % n_chunks  # each block's chunk
        bx = boxes[blk_b, c]
        prune = box_bound(tbox, bx) > tau
        computed = ~prune
        rows = computed[tile_of]
        base = np.where(bx[:, 7] < tn, BIG, np.float32(np.inf))  # an invalid or padded slot
        rmin = _scan(sel, qq, q2, chunk_rec[blk_b, c], chunk_idx[blk_b, c], tile_of, span, rows)
        rmin = np.where(active, np.minimum(rmin, base[tile_of]), np.inf)
        sel.finish(rows)
        chunk_min = rmin.reshape(blocks, TQ).min(1)
        new_tau = np.where(active, sel.td, -np.inf).reshape(blocks, TQ).max(1)
        skipped += int((prune | (computed & (chunk_min > tau))).sum())
        pruned += int(prune.sum())
        tau = np.where(computed, new_tau, tau)
    i, d = sel.result()
    return i.reshape(B, Mp, k)[:, :M], d.reshape(B, Mp, k)[:, :M], skipped, pruned


def emulate_baseline(q, xyz, mask, k, S, TQ, stats=None):
    """Kernel 13's selection at query tile TQ: (idx, d2) as the kernel
    returns them."""
    stats = {"merges": 0, "queued": 0} if stats is None else stats
    B, M, _ = q.shape
    N = xyz.shape[1]
    tn = tkb.chunk_points(N)
    qq, q2, rows_b, active, Mp = _rows(q, TQ, S)
    rec = _records(xyz, mask)
    sel = _Selection(qq.shape[0], active, k, S, stats)
    for base in range(0, N, tn):
        cnt = min(tn, N - base)
        span = -(-cnt // (S * UNROLL)) * (S * UNROLL)
        chunk = np.zeros((B, span, 4), np.float32)
        chunk[..., 3] = np.inf  # the padding: invalid records
        chunk[:, :cnt] = rec[:, base:base + cnt]
        cidx = np.full((B, span), NO_INDEX, np.int64)
        cidx[:, :cnt] = np.arange(base, base + cnt)
        _scan(sel, qq, q2, chunk, cidx, rows_b, span)
    sel.finish()
    i, d = sel.result()
    return i.reshape(B, Mp, k)[:, :M], d.reshape(B, Mp, k)[:, :M]


def _cloud(seed, B, N, M, lattice=False, sort=False, junk=False):
    """Queries (B, M, 3), points (B, N, 3) and a mask with holes: row 0
    keeps 70% of its points at random, row 1 only its first 10, any further
    row all. ``lattice`` puts points and queries on a coarse grid (exact
    ties everywhere); ``sort`` puts both in Morton order; ``junk`` gives
    invalid points inf and NaN coordinates."""
    rng = np.random.RandomState(seed)
    if lattice:
        xyz = (rng.randint(0, 5, (B, N, 3)) * 0.25).astype(np.float32)
        q = (rng.randint(0, 5, (B, M, 3)) * 0.25).astype(np.float32)
    else:
        xyz = (rng.rand(B, N, 3) * 0.4 - 0.2).astype(np.float32)
        q = (rng.rand(B, M, 3) * 0.4 - 0.2).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0] = rng.rand(N) < 0.7
    mask[1, 10:] = False
    if sort:
        order = tpo.spatial_sort_order(torch.from_numpy(xyz), torch.from_numpy(mask)).numpy()
        xyz = np.take_along_axis(xyz, order[..., None], 1)
        mask = np.take_along_axis(mask, order, 1)
        qo = tpo.spatial_sort_order(torch.from_numpy(q), torch.ones((B, M), dtype=torch.bool))
        q = np.take_along_axis(q, qo.numpy()[..., None], 1)
    if junk:
        bad = np.nonzero(~mask)
        xyz[bad[0][::3], bad[1][::3]] = np.inf
        xyz[bad[0][1::3], bad[1][1::3], 1] = np.nan
        xyz[bad[0][2::3], bad[1][2::3], 2] = -np.inf
    return q, xyz, mask


def _plain(q, xyz, mask, k):
    i, d = tpo.knn_query_padded_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                        for a in (q, xyz, mask)), k)
    return i.numpy(), d.numpy()


def _assert_same(got, ref):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1].view(np.int32), ref[1].view(np.int32))  # bit-equal


@pytest.mark.parametrize("k", [1, 4, 16, 33, 128])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32])
def test_dense_groups_match_plain_and_jax(S, k):
    # N = 2,333 is divisible by neither S nor the 1024-point tile; M = 45
    # leaves a block and a warp partly past M
    q, xyz, mask = _cloud(S * 131 + k, 3, 2333, 45)
    got = emulate_dense(q, xyz, mask, k, S)
    _assert_same(got, _plain(q, xyz, mask, k))
    ref_i, ref_d = jops.knn_query_padded(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), k)
    np.testing.assert_array_equal(got[0], np.asarray(ref_i))
    np.testing.assert_allclose(got[1], np.asarray(ref_d), rtol=1e-5, atol=1e-6)
    if k > 10:  # row 1 holds 10 valid points
        assert (got[0][1, :, 10:] == -1).all() and (got[1][1, :, 10:] == BIG).all()


@pytest.mark.parametrize("k", [4, 16, 128])
@pytest.mark.parametrize("S", [1, 8, 32])
def test_dense_groups_break_ties_and_skip_junk(S, k):
    # a lattice: exact ties everywhere, to the smaller index; invalid points
    # with inf and NaN coordinates never enter
    q, xyz, mask = _cloud(k + S, 2, 1500, 70, lattice=True, junk=True)
    _assert_same(emulate_dense(q, xyz, mask, k, S), _plain(q, xyz, mask, k))


class _Module(types.ModuleType):
    """A module with some attributes replaced."""

    def __init__(self, mod, **replaced):
        super().__init__(mod.__name__)
        self._mod = mod
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.mark.parametrize("S", [2, 32])
def test_dense_groups_match_the_pallas_kernel_in_interpret_mode(monkeypatch, S):
    monkeypatch.setattr(jknn3, "pl", _Module(
        jknn3.pl, pallas_call=functools.partial(jknn3.pl.pallas_call, interpret=True)))
    q, xyz, mask = _cloud(S, 2, 700, 40)
    ref_i, ref_d = jknn3.knn_query_padded_pallas3(jnp.asarray(q), jnp.asarray(xyz),
                                                  jnp.asarray(mask), 16)
    got = emulate_dense(q, xyz, mask, 16, S)
    np.testing.assert_array_equal(got[0], np.asarray(ref_i))
    np.testing.assert_allclose(got[1], np.asarray(ref_d), rtol=1e-5, atol=1e-6)


# (TQ, S): every tile the kernel takes, each with a group size it allows
@pytest.mark.parametrize("TQ,S", [(16, 2), (16, 16), (32, 1), (32, 8), (64, 1), (64, 4),
                                  (128, 1), (128, 2)])
def test_chunkskip_tiles_match_plain_and_skip_counts(TQ, S):
    q, xyz, mask = _cloud(TQ + S, 2, 2300, 300, sort=True)
    got_i, got_d, skipped, pruned = emulate_chunkskip(q, xyz, mask, 16, S, TQ)
    _assert_same((got_i, got_d), _plain(q, xyz, mask, 16))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, xyz, mask)]
    _, _, plain_skipped = tpo.knn_query_chunkskip_plain(*args, 16, with_skipped=True, tm=TQ)
    assert skipped == int(plain_skipped)
    assert 0 < pruned <= skipped < 2 * -(-300 // TQ) * 5  # of B * tiles * chunks


@pytest.mark.parametrize("k", [1, 33, 128])
def test_chunkskip_tiles_on_ties_junk_and_short_rows(k):
    q, xyz, mask = _cloud(k, 3, 1100, 90, sort=True, lattice=True, junk=True)
    S, TQ = (8, 16) if k == 128 else (2, 32)
    got_i, got_d, skipped, _ = emulate_chunkskip(q, xyz, mask, k, S, TQ)
    _assert_same((got_i, got_d), _plain(q, xyz, mask, k))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, xyz, mask)]
    assert skipped == int(tpo.knn_query_chunkskip_plain(*args, k, with_skipped=True, tm=TQ)[2])


def _baseline_plain(q, xyz, mask, k):
    i, d = tpo.knn_query_baseline_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                          for a in (q, xyz, mask)), k)
    return i.numpy(), d.numpy()


# every group size with each k its lists hold (k = 33 takes S >= 4, 128 S >= 8)
_BASELINE_SHAPES = [(S, k) for S in (1, 2, 4, 8, 16, 32) for k in (1, 16, 33, 128)
                    if tkn.list_rows(k, S) <= tkn.MAX_ROWS]


@pytest.mark.parametrize("S,k", _BASELINE_SHAPES)
def test_baseline_groups_match_plain_on_ties_junk_and_short_rows(S, k):
    # N = 4,500: three 2048-point chunks, the last of 404 points, divisible
    # by no lane step; M = 45 leaves a tile and a warp partly past M; a
    # lattice (exact ties), invalid points with inf and NaN coordinates, a
    # row of 10 valid points
    TQ = tkb.choose_tile(S)
    q, xyz, mask = _cloud(S * 7 + k, 3, 4500, 45, lattice=True, junk=True)
    got = emulate_baseline(q, xyz, mask, k, S, TQ)
    _assert_same(got, _baseline_plain(q, xyz, mask, k))
    _assert_same(got, _plain(q, xyz, mask, k))
    if k > 10:  # row 1 holds 10 valid points
        assert (got[0][1, :, 10:] == -1).all() and (got[1][1, :, 10:] == BIG).all()


@pytest.mark.parametrize("S,k", _BASELINE_SHAPES)
def test_baseline_groups_match_the_pallas_kernel_in_interpret_mode(monkeypatch, S, k):
    monkeypatch.setattr(jknn, "pl", _Module(
        jknn.pl, pallas_call=functools.partial(jknn.pl.pallas_call, interpret=True)))
    # random points (2,333: a 2048-point chunk and one of 285) and a lattice
    # (ties to the smaller index), invalid points with inf and NaN
    # coordinates, a row of 10 valid points; index-exact on both. The JAX
    # kernel forms q.p as its own product (XLA's order on the CPU), so its d2
    # is bit-equal on the lattice, whose coordinates make every sum exact,
    # and within 1e-5 relative on random points (a fifth to a quarter differ
    # by an ulp)
    for lattice in (False, True):
        q, xyz, mask = _cloud(S + k, 2, 2333, 40, lattice=lattice, junk=True)
        ref_i, ref_d = jknn.knn_query_padded_pallas(jnp.asarray(q), jnp.asarray(xyz),
                                                    jnp.asarray(mask), k)
        got = emulate_baseline(q, xyz, mask, k, S, tkb.choose_tile(S))
        if lattice:
            _assert_same(got, (np.asarray(ref_i), np.asarray(ref_d)))
        else:
            np.testing.assert_array_equal(got[0], np.asarray(ref_i))
            np.testing.assert_allclose(got[1], np.asarray(ref_d), rtol=1e-5, atol=1e-6)


def _bound_holds(q, p, valid):
    """box_bound of the boxes of queries q (n, 3) and points p (m, 3) is at
    most every dist2 of a query and a valid point."""
    q = q.astype(np.float32)
    rec = _records(p[None], valid[None])[0]
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    tbox = np.concatenate([q.min(0), q.max(0), [q2.max()]]).astype(np.float32)
    cbox = _chunk_boxes(rec[None], valid[None], len(p))[0, 0]
    bound = box_bound(tbox, cbox)
    if not valid.any():
        assert bound == BIG
        return
    d = _dist2(q[:, None], q2[:, None], rec[None, valid])
    assert bound <= d.min(), (bound, d.min())


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), offset=st.sampled_from([0.0, 1.0, 37.0, 1000.0]),
       gap=st.sampled_from([0.0, 1e-4, 0.01, 0.3, 2.0]), scale=st.sampled_from([1e-3, 0.05, 1.0]))
def test_box_bound_never_exceeds_a_distance(seed, offset, gap, scale):
    # the query box and the chunk box a `gap` apart along x, `offset` from
    # the origin (cancellation in dist2 grows with |q|^2 + |p|^2)
    rng = np.random.RandomState(seed % 2**32)
    q = (offset + rng.rand(40, 3) * scale).astype(np.float32)
    p = (offset + rng.rand(300, 3) * scale).astype(np.float32)
    p[:, 0] += np.float32(scale + gap)
    valid = rng.rand(300) < 0.9
    _bound_holds(q, p, valid)
    _bound_holds(q, q + np.float32(gap * 1e-3), np.ones(40, bool))  # touching, overlapping


def test_box_bound_at_the_edges():
    rng = np.random.RandomState(3)
    q = rng.rand(8, 3).astype(np.float32)
    _bound_holds(q, q.copy(), np.ones(8, bool))                 # the same points: dist2 0
    _bound_holds(q, q + 1.0, np.zeros(8, bool))                 # no valid point: 1e10
    far = (q + np.float32(1e6)).astype(np.float32)
    _bound_holds(q, far, np.ones(8, bool))                      # capped at 1e10
    assert box_bound(np.array([0, 0, 0, 0, 0, 0, 0], np.float32),
                     np.array([1e6, 0, 0, 1e6, 0, 0, 1e12, 1], np.float32)) == BIG


@pytest.mark.parametrize("N", [1, 2, 3, 10, 1303, 2333, 10240, 16400, 20480])
def test_visiting_order_is_a_permutation(N):
    A = tkn.order_multiplier(N)
    assert 1 <= A < max(N, 2) and np.gcd(A, N) == 1
    order = (np.arange(N, dtype=np.int64) * A) % N
    assert np.array_equal(np.sort(order), np.arange(N))


def _h100_model_group_rule(B, M, k, warps_per_sm, max_rows):
    fits = [S for S in tkn.GROUP_SIZES if tkn.list_rows(k, S) <= max_rows]
    filled = [S for S in fits if B * M * S / 32 >= warps_per_sm * H100_SMS]
    return filled[0] if filled else fits[-1]


@pytest.mark.parametrize("k", [1, 16, 33, 64, 128])
@pytest.mark.parametrize("M", [1, 100, 2048])
@pytest.mark.parametrize("B", [1, 4, 32, 64])
def test_group_and_tile_choosers_meet_their_rules(B, M, k):
    # the rules read B, M, k and the SM count; N does not enter them
    S = tkn.choose_group(B, M, k, H100_SMS)
    assert S == _h100_model_group_rule(B, M, k, tkn.WARPS_PER_SM, tkn.MAX_ROWS)
    assert tkn.list_rows(k, S) <= tkn.MAX_ROWS and S * tkn.list_rows(k, S) >= k
    S12 = tkc.choose_group(B, M, k, H100_SMS)
    fast = tkn.list_rows(k, 32) <= tkc.MAX_FAST_ROWS
    assert S12 == _h100_model_group_rule(B, M, k, tkc.WARPS_PER_SM,
                                         tkc.MAX_FAST_ROWS if fast else tkn.MAX_ROWS)
    assert tkn.list_rows(k, S12) <= (tkc.MAX_FAST_ROWS if fast else tkn.MAX_ROWS)
    TQ = tkc.choose_tile(S12)
    assert TQ * S12 == tkc.TILE_THREADS and TQ in (1, 2, 4, 8, 16, 32, 64, 128)
    assert 32 <= TQ * S12 <= tkc.MAX_THREADS and TQ <= tkc.MAX_TILE
    S13 = tkb.choose_group(B, M, k, H100_SMS)
    assert S13 == _h100_model_group_rule(B, M, k, tkb.WARPS_PER_SM, tkn.list_rows(k, 32))
    TQ13 = tkb.choose_tile(S13)
    assert TQ13 * S13 == min(tkb.TILE_THREADS, tkb.MAX_TILE * S13)
    assert 32 <= TQ13 * S13 <= tkb.MAX_THREADS and TQ13 <= tkb.MAX_TILE


def test_baseline_launch_shape_at_the_flagship(monkeypatch):
    # M = 2048 FPS queries: the sweep's best (S, TQ) at k = 16, B = 1, 4, 32
    # and at k = 128, B = 4 (scripts/knn_group_sweep.py, PERF.md)
    monkeypatch.setattr(tkn, "sm_count", lambda device: H100_SMS)
    assert [tkb.launch_shape(B, 2048, 16, 0) for B in (1, 4, 32)] == [(32, 8), (16, 16),
                                                                      (16, 16)]
    assert tkb.launch_shape(4, 2048, 128, 0) == (32, 8)
    assert tkb.choose_tile(1) == 128 and tkb.choose_group(1, 1, 4, H100_SMS) == 32
    assert tkb.chunk_points(100) == 128 and tkb.chunk_points(10240) == 2048


def test_chooser_cases_at_the_flagship():
    # M = 2048 FPS queries, k = 16: the sweep's best or within a few percent
    assert [tkn.choose_group(B, 2048, 16, H100_SMS) for B in (1, 4, 32, 64)] == [32, 8, 1, 1]
    assert [tkc.choose_group(B, 2048, 16, H100_SMS) for B in (1, 4, 32, 64)] == [32, 16, 8, 8]
    assert [tkc.choose_tile(S) for S in (1, 8, 16, 32)] == [128, 16, 8, 4]
    assert tkn.choose_group(1, 2048, 128, H100_SMS) == 32
    assert tkn.choose_group(64, 2048, 128, H100_SMS) == 8  # the list needs 8 lanes
    assert tkc.choose_group(64, 2048, 128, H100_SMS) == 8
    assert tkn.choose_group(1, 1, 4, H100_SMS) == 32 and tkc.choose_group(1, 1, 4, H100_SMS) == 32


def test_constants_match_the_sources():
    sel = _consts("knn_select.cuh")
    assert (int(sel["kQueue"]), int(sel["kUnroll"])) == (QUEUE, UNROLL)
    assert int(sel["kMaxRows"]) == tkn.MAX_ROWS and int(sel["kBoxFloats"]) == tkc.BOX_FLOATS
    assert np.float32(float(sel["kMargin"].rstrip("f"))) == MARGIN
    dense = _consts("knn.cu")
    assert int(dense["kThreads"]) == tkn.THREADS and int(dense["kTile"]) == TILE
    skip = _consts("knn_chunkskip.cu")
    assert int(skip["kMaxTile"]) == tkc.MAX_TILE and int(skip["kMaxThreads"]) == tkc.MAX_THREADS
    base = _consts("knn_baseline.cu")
    assert int(base["kMaxTile"]) == tkb.MAX_TILE and int(base["kMaxThreads"]) == tkb.MAX_THREADS
    assert int(base["kChunk"]) == tkb.chunk_points(10**6)
    assert int(_consts("knn_topk.cuh")["kMaxK"]) == tkn.MAX_K


_CTYPE_OF = {"int": ctypes.c_int}


def _prototype(source: str, name: str) -> list:
    """ctypes kinds of the parameters of ``int name(...)`` in ``source``."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    match = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", text)
    assert match, f"no prototype of {name}"
    return [ctypes.c_void_p if "*" in p else _CTYPE_OF[" ".join(p.split()[:-1])]
            for p in match.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("module,source,entry", [
    (tkn, "knn.cu", "pcm_knn"), (tkn, "knn.cu", "pcm_knn_order_multiplier"),
    (tkn, "knn.cu", "pcm_knn_max_rows"), (tkc, "knn_chunkskip.cu", "pcm_knn_chunkskip"),
    (tkc, "knn_chunkskip.cu", "pcm_knn_chunkskip_max_tile"),
    (tkb, "knn_baseline.cu", "pcm_knn_baseline"),
    (tkb, "knn_baseline.cu", "pcm_knn_baseline_max_threads")])
def test_wrapper_argtypes_match_c_prototypes(monkeypatch, module, source, entry):
    values = {"pcm_knn_max_k": tkn.MAX_K, "pcm_knn_max_rows": tkn.MAX_ROWS,
              "pcm_knn_threads": tkn.THREADS, "pcm_knn_chunkskip_max_tile": tkc.MAX_TILE,
              "pcm_knn_chunkskip_max_threads": tkc.MAX_THREADS,
              "pcm_knn_chunkskip_box_floats": tkc.BOX_FLOATS,
              "pcm_knn_baseline_max_tile": tkb.MAX_TILE,
              "pcm_knn_baseline_max_threads": tkb.MAX_THREADS}

    class FakeLib:
        def __getattr__(self, name):
            value = values.get(name, 0)
            fn = lambda *args: value  # noqa: E731
            fn.argtypes = fn.restype = None
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda name: FakeLib())
    fn = getattr(module._lib(), entry)
    want = _prototype(source, entry)
    assert len(fn.argtypes) == len(want)
    for i, (got, kind) in enumerate(zip(fn.argtypes, want)):
        assert got is kind, f"{entry} argument {i}: {got.__name__} for {kind.__name__}"
    assert fn.restype is ctypes.c_int
