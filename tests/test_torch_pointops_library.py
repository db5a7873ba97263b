"""The library surface of ``ops/pointops.py`` (JAX ``pointops.py:330-817``:
ball queries, grouping, subtraction, aggregation, interpolation, the
edge-list attention steps and the packed-offset wrappers) against the JAX
package's, on the CPU: indices exact, values within 1e-6 of max(1,
max|JAX|) (JAX's ``_sqdist`` expansion in f32 on both sides; sums of K
products round apart by an ulp of their size). The random ball query's
priorities are JAX's draw, patched into the port's ``uniform_priority``,
as the DP tests patch JAX's draws in. ``attention_fusion_step`` sums by a
sorted segment scan: two calls are bit-identical, and so are two orders of
the same edges' contributions to each target up to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops import pointops as jpo
from pointcloudmatters_tpu_torch.ops import pointops as tpo

ATOL = 1e-6
B, N, M, K = 2, 64, 20, 8


def _clouds(seed=0):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(B, N, 3) * 0.4).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [41]])
    new_xyz = np.concatenate([xyz[:, :M - 4], (rng.rand(B, 4, 3) * 0.4).astype(np.float32)], 1)
    return xyz, mask, new_xyz


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, ref, exact=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL * max(1.0, np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("max_r, min_r", [(0.06, 0.0), (0.3, 0.0), (0.2, 0.08)])
def test_ball_query_padded(max_r, min_r):
    xyz, mask, new_xyz = _clouds()
    ref = jpo.ball_query_padded(*_j(new_xyz, xyz, mask), K, max_r, min_r)
    got = tpo.ball_query_padded(*_t(new_xyz, xyz, mask), K, max_r, min_r)
    _same(got[0], ref[0], exact=True)
    _same(got[1], ref[1])
    counts = (got[0] >= 0).sum(-1)
    # short rows (-1 after the candidates), and oversampled ones (strided)
    assert counts.min() < K if max_r < 0.1 else counts.max() == K


def test_random_ball_query_padded(monkeypatch):
    xyz, mask, new_xyz = _clouds(1)
    key = jax.random.PRNGKey(3)
    prio = np.asarray(jax.random.uniform(key, (B, 1, N)))
    monkeypatch.setattr(tpo, "uniform_priority", lambda gen, shape, device: (
        torch.from_numpy(prio).reshape(shape)))
    ref = jpo.random_ball_query_padded(key, *_j(new_xyz, xyz, mask), K, 0.2, 0.0)
    got = tpo.random_ball_query_padded(None, *_t(new_xyz, xyz, mask), K, 0.2, 0.0)
    _same(got[0], ref[0], exact=True)
    _same(got[1], ref[1])


def test_grouping_subtraction_aggregation_interpolation():
    xyz, mask, new_xyz = _clouds(2)
    rng = np.random.RandomState(2)
    feat = rng.randn(B, N, 6).astype(np.float32)
    idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
    idx[0, :3, 5:] = -1
    for with_xyz in (False, True):
        _same(tpo.grouping_padded(*_t(idx, feat, xyz, new_xyz), with_xyz=with_xyz),
              jpo.grouping_padded(*_j(idx, feat, xyz, new_xyz), with_xyz=with_xyz))
    sub_idx = rng.randint(0, N, (B, N, K)).astype(np.int32)
    f2 = rng.randn(B, N, 6).astype(np.float32)
    _same(tpo.subtraction_padded(*_t(feat, f2, sub_idx)),
          jpo.subtraction_padded(*_j(feat, f2, sub_idx)))
    position = rng.randn(B, N, K, 6).astype(np.float32)
    weight = rng.randn(B, N, K, 3).astype(np.float32)
    _same(tpo.aggregation_padded(*_t(feat, position, weight, sub_idx)),
          jpo.aggregation_padded(*_j(feat, position, weight, sub_idx)))
    _same(tpo.interpolation_padded(*_t(xyz, new_xyz, feat, mask), k=3),
          jpo.interpolation_padded(*_j(xyz, new_xyz, feat, mask), k=3))
    got, got_idx = tpo.knn_query_and_group_padded(*_t(feat, xyz, mask, new_xyz), K,
                                                  with_xyz=True)
    ref, ref_idx = jpo.knn_query_and_group_padded(*_j(feat, xyz, mask, new_xyz), K,
                                                  with_xyz=True)
    _same(got_idx, ref_idx, exact=True)
    _same(got, ref)


def test_edge_attention_steps():
    rng = np.random.RandomState(3)
    n, g, c, m = 30, 2, 4, 200
    q, k, v = (rng.randn(n, g, c).astype(np.float32) for _ in range(3))
    w = rng.randn(c).astype(np.float32)
    tgt = rng.randint(0, n - 3, m).astype(np.int32)  # the last targets get no edge
    ref_ = rng.randint(0, n, m).astype(np.int32)
    _same(tpo.attention_relation_step(*_t(q, k, w, tgt, ref_)),
          jpo.attention_relation_step(*_j(q, k, w, tgt, ref_)))
    ew = rng.randn(m, g).astype(np.float32)
    got = tpo.attention_fusion_step(*_t(ew, v, tgt, ref_))
    _same(got, jpo.attention_fusion_step(*_j(ew, v, tgt, ref_)))
    assert torch.equal(got, tpo.attention_fusion_step(*_t(ew, v, tgt, ref_)))
    assert not got[n - 3:].any()
    assert tpo.attention_fusion_step(*_t(ew[:0], v, tgt[:0], ref_[:0])).abs().sum() == 0


# ---------------------------------------------------------------------------
# packed clouds
# ---------------------------------------------------------------------------

OFFSET = np.array([50, 73, 120], np.int64)
NEW_OFFSET = np.array([12, 20, 31], np.int64)


def _packed(seed=4):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(OFFSET[-1], 3) * 0.4).astype(np.float32)
    feat = rng.randn(OFFSET[-1], 5).astype(np.float32)
    return xyz, feat


def test_offsets():
    _same(tpo.offset2bincount(OFFSET), jpo.offset2bincount(OFFSET), exact=True)
    _same(tpo.offset2batch(OFFSET), jpo.offset2batch(OFFSET), exact=True)
    batch = jpo.offset2batch(OFFSET)
    got = tpo.batch2offset(torch.from_numpy(batch))
    assert got.dtype == torch.int32
    _same(got, jpo.batch2offset(batch), exact=True)


def test_packed_fps_knn_and_ball_queries(monkeypatch):
    xyz, feat = _packed()
    fps = tpo.farthest_point_sampling(*_t(xyz, OFFSET, NEW_OFFSET))
    _same(fps, jpo.farthest_point_sampling(xyz, OFFSET, NEW_OFFSET), exact=True)
    new_xyz = xyz[fps.long().numpy()]
    for args in ((xyz, OFFSET), (xyz, OFFSET, new_xyz, NEW_OFFSET)):
        got = tpo.knn_query(6, *_t(*args))
        ref = jpo.knn_query(6, *args)
        _same(got[0], ref[0], exact=True)
        _same(got[1], ref[1])
        got = tpo.ball_query(6, 0.15, 0.0, *_t(*args))
        ref = jpo.ball_query(6, 0.15, 0.0, *args)
        _same(got[0], ref[0], exact=True)
        _same(got[1], ref[1])
    key = jax.random.PRNGKey(5)
    n_max = int(np.diff(OFFSET, prepend=0).max())
    prio = np.asarray(jax.random.uniform(key, (3, 1, n_max)))
    monkeypatch.setattr(tpo, "uniform_priority", lambda gen, shape, device: (
        torch.from_numpy(prio).reshape(shape)))
    got = tpo.random_ball_query(6, 0.15, 0.02, *_t(xyz, OFFSET, new_xyz, NEW_OFFSET))
    ref = jpo.random_ball_query(6, 0.15, 0.02, xyz, OFFSET, new_xyz, NEW_OFFSET, key=key)
    _same(got[0], ref[0], exact=True)
    _same(got[1], ref[1])


def test_packed_grouping_and_friends():
    xyz, feat = _packed(5)
    rng = np.random.RandomState(5)
    fps = jpo.farthest_point_sampling(xyz, OFFSET, NEW_OFFSET)
    new_xyz = xyz[fps]
    idx = jpo.knn_query(6, xyz, OFFSET, new_xyz, NEW_OFFSET)[0].copy()
    idx[0, 4:] = -1
    for with_xyz in (False, True):
        _same(tpo.grouping(*_t(idx, feat, xyz, new_xyz), with_xyz=with_xyz),
              jpo.grouping(idx, feat, xyz, new_xyz, with_xyz=with_xyz))
    _same(tpo.grouping2(*_t(feat, idx)), jpo.grouping2(feat, idx))
    _same(tpo.interpolation(*_t(xyz, new_xyz, feat, OFFSET, NEW_OFFSET)),
          jpo.interpolation(xyz, new_xyz, feat, OFFSET, NEW_OFFSET))
    assert tpo.interpolation2 is tpo.interpolation
    sidx = rng.randint(-1, OFFSET[-1], (OFFSET[-1], 4))
    _same(tpo.subtraction(*_t(feat, feat[::-1], sidx)), jpo.subtraction(feat, feat[::-1], sidx))
    position = rng.randn(OFFSET[-1], 4, 5).astype(np.float32)
    weight = rng.randn(OFFSET[-1], 4, 1).astype(np.float32)
    _same(tpo.aggregation(*_t(feat, position, weight, sidx)),
          jpo.aggregation(feat, position, weight, sidx))
    for fn in (tpo.knn_query_and_group, jpo.knn_query_and_group):
        assert fn is not None
    got = tpo.knn_query_and_group(*_t(feat, xyz, OFFSET, new_xyz, NEW_OFFSET), nsample=5,
                                  with_xyz=True)
    ref = jpo.knn_query_and_group(feat, xyz, OFFSET, new_xyz, NEW_OFFSET, nsample=5,
                                  with_xyz=True)
    _same(got[1], ref[1], exact=True)
    _same(got[0], ref[0])
    got = tpo.ball_query_and_group(*_t(feat, xyz, OFFSET, new_xyz, NEW_OFFSET), max_radio=0.15,
                                   nsample=5)
    ref = jpo.ball_query_and_group(feat, xyz, OFFSET, new_xyz, NEW_OFFSET, max_radio=0.15,
                                   nsample=5)
    _same(got[1], ref[1], exact=True)
    _same(got[0], ref[0])


@pytest.mark.parametrize("dilation", [0, 1, 4])
def test_query_and_group(dilation):
    xyz, feat = _packed(6)
    fps = jpo.farthest_point_sampling(xyz, OFFSET, NEW_OFFSET)
    new_xyz = xyz[fps]
    # dilation 4: 1 + 5 * 5 = 26 neighbours; the second cloud (23 points) is shorter
    got = tpo.query_and_group(6, *_t(xyz, new_xyz, feat), None, *_t(OFFSET, NEW_OFFSET),
                              dilation=dilation)
    ref = jpo.query_and_group(6, xyz, new_xyz, feat, None, OFFSET, NEW_OFFSET, dilation=dilation)
    _same(got[1], ref[1], exact=True)
    _same(got[0], ref[0])
    _same(tpo.query_and_group(6, *_t(xyz, new_xyz, feat), None, *_t(OFFSET, NEW_OFFSET),
                              dilation=dilation, with_feat=False), ref[1], exact=True)
