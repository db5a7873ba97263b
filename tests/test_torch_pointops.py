"""Parity of the port's point ops (pointcloudmatters_tpu_torch/ops/pointops.py)
with the JAX package's XLA formulations, on the CPU.

On a CPU tensor the port runs each kernel's plain PyTorch version; the CUDA
kernels are held against those plain versions on the card by chip_smoke.py.
Inputs come from numpy seeds and go to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops import pointops as jops
from pointcloudmatters_tpu_torch import ops as tops
from pointcloudmatters_tpu_torch.ops import fps as tfps
from pointcloudmatters_tpu_torch.ops import knn as tknn
from pointcloudmatters_tpu_torch.ops import pointops as tpo


def _cloud(seed, B, N, counts, grid=False):
    """(B, N, 3) f32 coordinates and a (B, N) mask with counts[b] valid
    points at the front. The last row repeats its first half (exact
    duplicate points); ``grid`` puts every point on a coarse lattice, where
    distances are exact and equal distances abound."""
    rng = np.random.RandomState(seed)
    if grid:
        xyz = (rng.randint(0, 5, (B, N, 3)) * 0.25).astype(np.float32)
    else:
        xyz = (rng.rand(B, N, 3) * 0.4 - 0.2).astype(np.float32)
    xyz[-1, N // 2:] = xyz[-1, : N - N // 2]
    mask = np.arange(N)[None] < np.asarray(counts)[:, None]
    return xyz, mask


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("N,npoints", [(64, 16), (64, 64), (300, 16), (300, 64)])
def test_fps_index_exact(N, npoints, grid):
    # row 1 has fewer valid points than npoints: indices repeat
    xyz, mask = _cloud(N + npoints, 3, N, [N, 10, N - 7], grid)
    ref = np.asarray(jops._farthest_point_sampling_padded_xla(
        jnp.asarray(xyz), jnp.asarray(mask), npoints))
    got = tpo.farthest_point_sampling_padded(
        torch.from_numpy(xyz), torch.from_numpy(mask), npoints)
    assert got.dtype == torch.int32 and got.shape == (3, npoints)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("k", [4, 16])
def test_knn_exact(k, grid):
    B, N, M = 3, 300, 40
    # rows 1 and 2 hold fewer valid points than k=16
    xyz, mask = _cloud(k, B, N, [N, 3, 11], grid)
    q = _cloud(k + 1, B, M, [M] * B, grid)[0]
    ref_i, ref_d = jops.knn_query_padded(
        jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), k)
    got_i, got_d = tpo.knn_query_padded(
        torch.from_numpy(q), torch.from_numpy(xyz), torch.from_numpy(mask), k)
    assert got_i.dtype == torch.int32 and got_i.shape == (B, M, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-6)


def test_knn_fewer_points_than_k():
    xyz, mask = _cloud(5, 2, 6, [6, 2])
    q = _cloud(6, 2, 4, [4, 4])[0]
    ref_i, ref_d = jops.knn_query_padded(
        jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(mask), 8)
    got_i, got_d = tpo.knn_query_padded(
        torch.from_numpy(q), torch.from_numpy(xyz), torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-6)
    assert (got_i.numpy()[1, :, 2:] == -1).all()
    assert (got_d.numpy()[1, :, 2:] == 1e10).all()


def test_gather_rows_padded():
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 30, 5).astype(np.float32)
    idx = rng.randint(-1, 30, (2, 7, 4)).astype(np.int32)
    ref = jops.gather_rows_padded(jnp.asarray(feat), jnp.asarray(idx))
    got = tpo.gather_rows_padded(torch.from_numpy(feat), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_tensors_launch_no_kernel():
    tops.reset_launch_counts()
    xyz, mask = _cloud(7, 2, 64, [64, 40])
    x, m = torch.from_numpy(xyz), torch.from_numpy(mask)
    idx = tpo.farthest_point_sampling_padded(x, m, 8)
    new_xyz = torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 3))
    tpo.knn_query_padded(new_xyz, x, m, 4)
    counts = tops.launch_counts()
    assert {"fps", "knn", "attention_fwd", "attention_bwd"} <= set(counts)
    assert not any(counts.values()), counts


def test_kernel_wrappers_refuse_cpu_tensors():
    xyz, mask = _cloud(8, 1, 16, [16])
    x, m = torch.from_numpy(xyz), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="CUDA"):
        tfps.farthest_point_sampling_padded_cuda(x, m, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_query_padded_cuda(x, x, m, 4)
    assert tops.launch_counts()["fps"] == tops.launch_counts()["knn"] == 0
