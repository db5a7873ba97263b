"""The port's kNN selectors (``PCM_KNN_IMPL``) against the JAX package, on
the CPU.

The plain versions of the chunk-skip kernel 12 and the dense-scan kernel 13
(``pointcloudmatters_tpu_torch/ops/pointops.py``) are held against the TPU
kernels themselves, ``pallas_knn2.knn_query_padded_pallas2`` and
``pallas_knn.knn_query_padded_pallas``, run in Pallas interpret mode (the
modules are handed a ``pl`` whose ``pallas_call`` has ``interpret=True``;
no file of the JAX package changes). The selector :func:`knn_route` is held
against JAX's gate in ``pointops.knn_query_padded``, and the port's
chunk-skip route (Morton sort, plain kernel 12, un-permute) against JAX's
whole route with ``_use_pallas`` patched to True. The CUDA kernels are held
against these plain versions on the card by chip_smoke.py. Inputs come from
numpy seeds and go to both frameworks.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops import pallas_knn as jknn
from pointcloudmatters_tpu.ops import pallas_knn2 as jknn2
from pointcloudmatters_tpu.ops import pallas_knn3 as jknn3
from pointcloudmatters_tpu.ops import pointops as jops
from pointcloudmatters_tpu_torch import ops as tops
from pointcloudmatters_tpu_torch.entry import morton_order
from pointcloudmatters_tpu_torch.ops import knn_baseline as tkb
from pointcloudmatters_tpu_torch.ops import knn_chunkskip as tkc
from pointcloudmatters_tpu_torch.ops import pointops as tpo


class _Module(types.ModuleType):
    """A module with some attributes replaced."""

    def __init__(self, mod, **replaced):
        super().__init__(mod.__name__)
        self._mod = mod
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX kNN kernels 12 and 13 in Pallas interpret mode."""
    for mod in (jknn, jknn2):
        monkeypatch.setattr(mod, "pl", _Module(
            mod.pl, pallas_call=functools.partial(mod.pl.pallas_call, interpret=True)))


def _cloud(seed, B, N, M, sort=False, lattice=False):
    """Queries (B, M, 3), points (B, N, 3) and a mask with holes: row 0
    keeps 70% of its points at random, row 1 only its first 10 (fewer than
    k = 16), any further row all. ``sort`` puts points and queries in Morton
    order; ``lattice`` puts every point on a
    coarse grid, where equal distances abound."""
    rng = np.random.RandomState(seed)
    if lattice:
        xyz = (rng.randint(0, 5, (B, N, 3)) * 0.25).astype(np.float32)
        q = (rng.randint(0, 5, (B, M, 3)) * 0.25).astype(np.float32)
    else:
        xyz = rng.rand(B, N, 3).astype(np.float32)
        q = rng.rand(B, M, 3).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0] = rng.rand(N) < 0.7
    mask[1, 10:] = False
    if sort:  # the port's order, bit-equal to JAX's (test_morton_codes_match_jax)
        order = tpo.spatial_sort_order(*_torch(xyz, mask)).numpy()
        xyz = np.take_along_axis(xyz, order[..., None], 1)
        mask = np.take_along_axis(mask, order, 1)
        qorder = tpo.spatial_sort_order(*_torch(q, np.ones((B, M), bool))).numpy()
        q = np.take_along_axis(q, qorder[..., None], 1)
    return q, xyz, mask


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (the port's plain version, the TPU kernel, a cloud size of a few chunks:
# 512-point chunks for kernel 12, 2048-point ones for kernel 13)
_SELECTORS = {
    "chunkskip": (tpo.knn_query_chunkskip_plain, jknn2.knn_query_padded_pallas2, 1500),
    "baseline": (tpo.knn_query_baseline_plain, jknn.knn_query_padded_pallas, 4500),
}


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("selector", ["chunkskip", "baseline"])
def test_plain_selectors_match_tpu_kernels(interpret, selector, k, sort):
    plain, tpu, N = _SELECTORS[selector]
    q, xyz, mask = _cloud(k + sort, 2, N, 200, sort=sort)
    ref_i, ref_d = tpu(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), k)
    got_i, got_d = plain(*_torch(q, xyz, mask), k)
    assert got_i.dtype == torch.int32 and got_i.shape == (2, 200, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-6, atol=1e-6)
    if k > 10:  # row 1 holds 10 valid points
        assert (got_i.numpy()[1, :, 10:] == -1).all()


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("selector", ["chunkskip", "baseline"])
def test_plain_selectors_break_ties_like_plain_knn(selector, k):
    # a lattice cloud: exact ties everywhere, which both kernels resolve to
    # the smaller index, as knn_query_padded_plain's stable sort does
    plain = _SELECTORS[selector][0]
    args = _torch(*_cloud(k, 3, 2300, 300, sort=True, lattice=True))
    ref_i, ref_d = tpo.knn_query_padded_plain(*args, k)
    got_i, got_d = plain(*args, k)
    torch.testing.assert_close(got_i, ref_i, rtol=0, atol=0)
    torch.testing.assert_close(got_d, ref_d, rtol=0, atol=0)


def test_chunkskip_plain_skips_on_sorted_clouds():
    # the early-out fires on Morton-sorted inputs and changes no result
    args = _torch(*_cloud(3, 2, 4096, 512, sort=True))
    got_i, got_d, skipped = tpo.knn_query_chunkskip_plain(*args, 16, with_skipped=True)
    ref_i, ref_d = tpo.knn_query_padded_plain(*args, 16)
    assert torch.equal(got_i, ref_i) and torch.equal(got_d, ref_d)
    assert skipped.dtype == torch.int32 and skipped.ndim == 0
    assert 0 < int(skipped) < 2 * 4 * 8  # of B * tiles * chunks


@pytest.mark.parametrize("k", [96, 128, 160])
def test_large_k_against_xla(k):
    q, xyz, mask = _cloud(k, 2, 600, 64)
    ref_i, ref_d = jops.knn_query_padded(jnp.asarray(q), jnp.asarray(xyz),
                                         jnp.asarray(mask), k)
    args = _torch(q, xyz, mask)
    for got_i, got_d in [tpo.knn_query_padded(*args, k)] + (
            [tpo.knn_query_chunkskip_plain(*args, k), tpo.knn_query_baseline_plain(*args, k)]
            if k <= 128 else []):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5, atol=1e-6)
    # past the kernels' 128 the card takes the plain version too, as JAX XLA
    assert tpo.knn_route("v3", 600, k, "cuda") == ("v3" if k <= 128 else "plain")


def test_morton_codes_match_jax():
    rng = np.random.RandomState(0)
    coord = (rng.rand(3, 700, 3) * 0.4 - 0.2).astype(np.float32)
    coord[1, :300] = coord[1, 300:600]  # duplicate points: equal codes
    valid = rng.rand(3, 700) < 0.8
    valid[2] = True
    ref = np.asarray(jops.morton_codes_padded(jnp.asarray(coord), jnp.asarray(valid)))
    got = tpo.morton_codes_padded(*_torch(coord, valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_o = np.asarray(jops.spatial_sort_order(jnp.asarray(coord), jnp.asarray(valid)))
    got_o = tpo.spatial_sort_order(*_torch(coord, valid))
    np.testing.assert_array_equal(got_o.numpy(), ref_o)
    # on a full cloud, the host order of the collate (entry.morton_order)
    np.testing.assert_array_equal(got_o[2].numpy(), morton_order(coord[2]))


@pytest.mark.parametrize("impl", ["v3", "chunkskip", "baseline"])
def test_knn_route_matches_jax_gate(monkeypatch, impl):
    called = []

    def stub(name):
        def fn(new_xyz, xyz, mask, nsample, **_):
            called.append(name)
            shape = new_xyz.shape[:2] + (nsample,)
            return jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.float32)
        return fn

    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(jknn3, "knn_query_padded_pallas3", stub("v3"))
    monkeypatch.setattr(jknn2, "knn_query_padded_pallas2", stub("chunkskip"))
    monkeypatch.setattr(jknn, "knn_query_padded_pallas", stub("baseline"))
    monkeypatch.setattr(jops, "_knn_query_padded_xla", stub("plain"))
    monkeypatch.setenv("PCM_KNN_IMPL", impl)
    q = jnp.zeros((1, 8, 3), jnp.float32)
    for n in (16384, 16385):
        xyz = jnp.zeros((1, n, 3), jnp.float32)
        for k in (128, 129):
            jops.knn_query_padded(q, xyz, jnp.ones((1, n), bool), k)
            assert tpo.knn_route(impl, n, k, "cuda") == called[-1], (n, k, called)
            assert tpo.knn_route(impl, n, k, "cpu") == "plain"
    assert called == (["v3", "plain", "chunkskip", "plain"] if impl == "v3" else
                      [impl, "plain"] * 2)


def test_knn_impl_typo_raises(monkeypatch):
    monkeypatch.setenv("PCM_KNN_IMPL", "bogus")
    q, xyz, mask = _cloud(1, 2, 64, 8)
    with pytest.raises(ValueError, match="PCM_KNN_IMPL"):
        jops.knn_query_padded(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), 4)
    with pytest.raises(ValueError, match="PCM_KNN_IMPL"):
        tpo.knn_query_padded(*_torch(q, xyz, mask), 4)
    with pytest.raises(ValueError, match="PCM_KNN_IMPL"):
        tpo.knn_route("bogus", 64, 4, "cuda")


@pytest.mark.parametrize("impl", [None, "v3", "chunkskip", "baseline"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, impl):
    if impl is None:
        monkeypatch.delenv("PCM_KNN_IMPL", raising=False)
    else:
        monkeypatch.setenv("PCM_KNN_IMPL", impl)
    tops.reset_launch_counts()
    args = _torch(*_cloud(2, 2, 300, 40))
    got = tpo.knn_query_padded(*args, 16)
    ref = tpo.knn_query_padded_plain(*args, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    counts = tops.launch_counts()
    assert {"knn", "knn_chunkskip", "knn_baseline"} <= set(counts)
    assert not any(counts.values()), counts


def test_selector_wrappers_refuse_cpu_tensors():
    q, xyz, mask = _torch(*_cloud(4, 2, 64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tkc.knn_query_chunkskip_cuda(q, xyz, mask, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tkb.knn_query_baseline_cuda(q, xyz, mask, 4)
    counts = tops.launch_counts()
    assert counts["knn_chunkskip"] == counts["knn_baseline"] == 0


def test_chunkskip_route_matches_jax_route(interpret, monkeypatch):
    # N = 16,400 > 16,384: JAX's default v3 falls back to the chunk-skip
    # kernel on Morton-sorted queries, and so does the port's gate
    monkeypatch.delenv("PCM_KNN_IMPL", raising=False)
    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    calls, kernel = [], jknn2.knn_query_padded_pallas2
    monkeypatch.setattr(jknn2, "knn_query_padded_pallas2",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    rng = np.random.RandomState(7)
    N = 16400
    xyz = rng.rand(1, N, 3).astype(np.float32)
    mask = rng.rand(1, N) < 0.9
    q = rng.rand(1, 128, 3).astype(np.float32)
    ref_i, ref_d = jops.knn_query_padded(jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), 16)
    assert calls == [1]
    assert tpo.knn_route("v3", N, 16, "cuda") == "chunkskip"
    got_i, got_d = tpo.knn_query_chunkskip(*_torch(q, xyz, mask), 16)
    got_i, ref_i = got_i.numpy(), np.asarray(ref_i)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-6, atol=1e-6)
    # 16,400 points leave a few near ties that the TPU kernel's matmul
    # distance and the port's elementwise one round to a different order:
    # where the picks differ, both are equally near in float64
    differ = got_i != ref_i
    assert differ.mean() < 2e-3, differ.sum()
    exact = lambda idx: ((xyz[0][idx] - q[0][:, None, :]).astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(exact(got_i[0])[differ[0]], exact(ref_i[0])[differ[0]],
                               rtol=0, atol=1e-6)
