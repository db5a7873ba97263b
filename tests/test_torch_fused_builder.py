"""The port's data-source token builder (``ops/fused_builder.py``) against
the JAX package's, on the CPU.

The JAX forward kernel runs only on the TPU; its own CPU oracle is
``_core_xla`` and ``grouped_stats_data(..., impl="xla")``, which is what the
port's plain versions are held to here. Inputs (holes, all-hole queries,
duplicate neighbours for exact ties, as ``tests/test_fused_builder.py``
builds them) come from numpy seeds. Tolerances, each with its reason:

- the bf16 core: vmax, vmin and the tie bitmap bit-equal (the same
  bf16-rounded differences compared the same way); sg within one bf16 ulp
  (an f32 sum of 16 rows in another order, then rounded); totals within
  1e-4 of their largest entry (f32 sums of ~500k terms of either sign in
  another order);
- ``grouped_stats_data`` at bf16 against JAX: vmax/vmin within one bf16
  ulp (each framework computes ``g = src @ W`` with its own bf16 matmul,
  which may round a sum of products the other way), totals as above, dW
  and dh within 2e-2 of each tensor's largest entry (bf16 products summed
  in another order, then rounded to bf16: a few bf16 ulps);
- in f32 against autograd of the unfused expression: 5e-3 of the largest
  entry, the limit of the JAX package's own test, since the backward
  rounds the source rows and the routed cotangents to bf16 in every
  precision (``fused_builder.py:474, 489-490``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.components.nn_utils import GroupedBNReluMax as JBuilder
from pointcloudmatters_tpu.ops import fused_builder as jfb
from pointcloudmatters_tpu_torch.models.components.nn_utils import GroupedBNReluMax
from pointcloudmatters_tpu_torch.ops import fused_builder as tfb
from pointcloudmatters_tpu_torch.ops.pointops import gather_rows_padded

BF16 = torch.bfloat16


def _mk(seed=0, B=2, N=384, M=256, K=16, D=128, Cin=9):
    rng = np.random.RandomState(seed)
    src = (rng.randn(B, N, Cin) * 0.4).astype(np.float32)
    query = (rng.randn(B, M, Cin) * 0.4).astype(np.float32)
    W = (rng.randn(Cin, D) * 0.1).astype(np.float32)
    nn = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn[:, -8:, :] = -1                 # all-hole (padding) queries
    nn[0, 3, 5:] = nn[0, 3, 0]         # duplicate neighbours -> exact ties
    nn[1, 7, ::2] = -1                 # partial holes
    return src, query, W, nn


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, held as f32 (exact in either framework)."""
    return torch.from_numpy(x).to(BF16).float().numpy()


def _j(x, dtype=jnp.bfloat16):
    return jnp.asarray(x, dtype)


def _t(x, dtype=BF16):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _within_ulp(a, b) -> bool:
    """Each entry of ``a`` within one bf16 ulp of ``b``'s (inf equal)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(b)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b[fin]), 1e-30))) - 7)
    return bool(np.array_equal(a[~fin], b[~fin]) and (np.abs(a[fin] - b[fin]) <= ulp).all())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1e-30, np.abs(b).max()))


@pytest.mark.parametrize("Cin", [9, 131])
def test_plain_core_matches_jax_core_xla_bf16(Cin):
    src, query, W, nn = _mk(Cin=Cin)
    g = _bf16(np.einsum("bnc,cd->bnd", src, W))
    h = _bf16(np.einsum("bmc,cd->bmd", query, W))
    ref = jax.jit(jfb._core_xla)(_j(g), _j(h), jnp.asarray(nn))
    got = tfb.builder_core_plain(_t(g), _t(h), torch.from_numpy(nn))
    for name, a, b in zip(("vmax", "vmin"), got[:2], ref[:2]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32),
                                      err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]), err_msg="bm")
    sg, sg_ref = got[2].float().numpy(), np.asarray(ref[2], np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(sg_ref), 1e-30))) - 7)
    assert (np.abs(sg - sg_ref) <= ulp).all()
    for a, b in zip(got[4:], ref[4:]):
        assert _rel(a, b) < 1e-4
    # the tie structure is exercised: duplicate neighbours share tie bits,
    # all-hole queries have none, every live query has a max and a min tie
    bm = got[3].numpy().view(np.uint32)
    row = bm[0, 3]
    assert np.array_equal(row & 1, (row >> 5) & 1)
    assert (bm[:, -8:] == 0).all()
    live = (nn >= 0).any(-1)
    assert ((bm[live] & 0xFFFF) != 0).all() and ((bm[live] >> 16) != 0).all()


@pytest.mark.parametrize("Cin", [9, 131])
def test_grouped_stats_data_matches_jax_bf16(Cin):
    """Forward and the (dW, dh) cotangents of the bf16 boundary against
    ``jax.vjp`` of JAX ``grouped_stats_data(impl="xla")``."""
    src, query, W, nn = _mk(seed=1, Cin=Cin)
    src, query, W = _bf16(src), _bf16(query), _bf16(W)
    rng = np.random.RandomState(2)
    B, M, K = nn.shape
    D = W.shape[1]
    cot = (_bf16(rng.randn(B, M, D).astype(np.float32)),
           _bf16(rng.randn(B, M, D).astype(np.float32)),
           rng.randn(D).astype(np.float32) * 1e-2, rng.randn(D).astype(np.float32) * 1e-3)

    def jf(W, h):
        return jfb.grouped_stats_data(_j(src), W, h, jnp.asarray(nn), impl="xla")

    h = _bf16(np.einsum("bmc,cd->bmd", query, W))
    ref, vjp = jax.vjp(jax.jit(jf), _j(W), _j(h))  # jitted, as a training step runs it
    ref_dW, ref_dh = vjp((_j(cot[0]), _j(cot[1]), jnp.asarray(cot[2]), jnp.asarray(cot[3])))

    tW, th = _t(W).requires_grad_(), _t(h).requires_grad_()
    got = tfb.grouped_stats_data(_t(src), tW, th, torch.from_numpy(nn))
    torch.autograd.backward(got, [_t(cot[0]), _t(cot[1]), torch.from_numpy(cot[2]),
                                  torch.from_numpy(cot[3])])
    for a, b in zip(got[:2], ref[:2]):
        assert _within_ulp(a.detach().float(), b)
    for a, b in zip(got[2:], ref[2:]):
        assert _rel(a.detach(), b) < 1e-4
    assert tW.grad.dtype == BF16 and th.grad.dtype == BF16
    assert _rel(tW.grad.float(), ref_dW) < 2e-2
    assert _rel(th.grad.float(), ref_dh) < 2e-2


def _unfused(g, h, nn_idx):
    hole = (nn_idx < 0)[..., None]
    gg = torch.where(hole, 0.0, gather_rows_padded(g, nn_idx))
    x = gg - h[:, :, None, :]
    vmax = torch.where(hole, -torch.inf, x).amax(dim=2)
    vmin = torch.where(hole, torch.inf, x).amin(dim=2)
    xz = torch.where(hole, 0.0, x)
    return vmax, vmin, xz.sum(dim=(0, 1, 2)), (xz * xz).sum(dim=(0, 1, 2))


def _scalarize(outs, cvec):
    vmax, vmin, total, total_sq = outs
    vmax = torch.where(torch.isfinite(vmax), vmax, 0.0)
    vmin = torch.where(torch.isfinite(vmin), vmin, 0.0)
    return ((vmax * cvec).sum() + (vmin * (cvec + 0.3)).sum()
            + total.sum() * 1e-3 + total_sq.sum() * 1e-4)


def test_f32_gradients_match_autograd_of_unfused():
    src, query, W, nn = (torch.from_numpy(a) for a in _mk())
    cvec = torch.from_numpy(np.random.RandomState(1).randn(*nn.shape[:2], W.shape[1])
                            .astype(np.float32) * 0.1)
    W_ref, W_got = W.clone().requires_grad_(), W.clone().requires_grad_()
    ref = _unfused(src @ W_ref, query @ W_ref, nn)
    got = tfb.grouped_stats_data(src, W_got, query @ W_got, nn)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(a, b)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5)
    _scalarize(ref, cvec).backward()
    _scalarize(got, cvec).backward()
    a, b = W_got.grad.numpy(), W_ref.grad.numpy()
    assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 5e-3


def test_routed_and_popcount_match_jax():
    """The plain routed term against JAX ``_routed_dw_xla`` on the same
    bf16 inputs (f32 sums: rtol 1e-5), and ``popcount16`` against JAX's."""
    src, query, W, nn = _mk(seed=3, Cin=131)
    g = _bf16(np.einsum("bnc,cd->bnd", src, W))
    h = _bf16(np.einsum("bmc,cd->bmd", query, W))
    bm = tfb.builder_core_plain(_t(g), _t(h), torch.from_numpy(nn))[3]
    rng = np.random.RandomState(4)
    dvx, dvn = (_bf16(rng.randn(*bm.shape).astype(np.float32)) for _ in range(2))
    srcb = _bf16(src)
    got = tfb.routed_dw_plain(_t(srcb), torch.from_numpy(nn), bm, _t(dvx), _t(dvn))
    gathered = np.stack([srcb[b][np.maximum(nn[b], 0)] for b in range(nn.shape[0])])
    inpg = np.where((nn < 0)[..., None], 0.0, gathered)  # (B, M, K, Cin)
    ref = jfb._routed_dw_xla(_j(inpg.transpose(0, 2, 3, 1)),
                             jnp.asarray(bm.numpy().transpose(0, 2, 1)),
                             _j(dvx.transpose(0, 2, 1)), _j(dvn.transpose(0, 2, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    v = np.random.RandomState(5).randint(-2**31, 2**31 - 1, 1000).astype(np.int32)
    np.testing.assert_array_equal(tfb.popcount16(torch.from_numpy(v)).numpy(),
                                  np.asarray(jfb._popcount16(jnp.asarray(v))))
    np.testing.assert_array_equal(tfb.popcount16(torch.from_numpy(v) >> 16).numpy(),
                                  np.asarray(jfb._popcount16(jnp.asarray(v) >> 16)))


def test_resolve_impl_gating(monkeypatch):
    """As ``tests/test_fused_builder.py::test_resolve_impl_gating``: fused
    only for bf16 on the card at shapes the JAX gate takes; the CPU, f32 and
    unsupported shapes take the plain chain; ``PCM_BUILDER_IMPL`` forces."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    resolve = GroupedBNReluMax.resolve_impl
    assert resolve(10240, 2048, 16, 512, BF16, cuda) == "fused"
    assert resolve(10240, 2048, 16, 512, BF16, cpu) == "xla"
    assert resolve(10240, 2048, 16, 512, torch.float32, cuda) == "xla"
    assert resolve(10240, 2048, 16, 6, BF16, cuda) == "xla"  # pre_sample width
    assert JBuilder.resolve_impl(10240, 2048, 16, 512, jnp.float32) == "xla"
    for n, m, k, d in ((10240, 2048, 17, 512), (10240, 2048, 16, 72),
                       (200000, 2048, 16, 512), (10240, 2048, 16, 512),
                       (24576, 2048, 16, 512), (24577, 2048, 16, 512),
                       (384, 256, 16, 128), (10240, 2048, 16, 6)):
        assert tfb.fused_builder_supported(n, m, k, d) == jfb.fused_builder_supported(
            n, m, k, d), (n, m, k, d)
    monkeypatch.setenv("PCM_BUILDER_IMPL", "xla")
    assert resolve(10240, 2048, 16, 512, BF16, cuda) == "xla"
    monkeypatch.setenv("PCM_BUILDER_IMPL", "fused")
    assert resolve(10240, 2048, 16, 512, BF16, cuda) == "fused"
    with pytest.raises(ValueError):
        resolve(10240, 2048, 16, 512, BF16, cpu)


def test_module_fused_route_matches_plain_chain_bf16():
    """``GroupedBNReluMax`` in train mode on its ``fused_data`` route against
    its plain chain at bf16, the same variables: output, running statistics
    and the h gradient equal bit for bit (the same values summed the same
    way), W's gradient within 2e-2 of its largest entry (the factorised
    backward sums in f32 what autograd sums in bf16)."""
    src, query, W, nn = _mk(seed=6)
    src, query, W = _t(_bf16(src)), _t(_bf16(query)), _t(_bf16(W))
    nn_t = torch.from_numpy(nn)
    cot = _t(np.random.RandomState(7).rand(*nn.shape[:2], W.shape[1]).astype(np.float32))
    outs = []
    for impl in ("xla", "fused_data"):
        mod = GroupedBNReluMax(W.shape[1])
        with torch.no_grad():
            mod.scale.copy_(torch.linspace(-1.5, 1.5, W.shape[1]))
            mod.bias.copy_(torch.linspace(-0.2, 0.3, W.shape[1]))
        w = W.clone().requires_grad_()
        h = query @ w
        kw = dict(src=src, W=w, impl=impl) if impl == "fused_data" else {}
        out = mod(src @ w if impl == "xla" else None, h, nn_t, use_running_average=False,
                  **kw)
        out.backward(cot)
        outs.append((out.detach(), mod.mean.clone(), mod.var.clone(), w.grad.float()))
    (o1, m1, v1, g1), (o2, m2, v2, g2) = outs
    assert torch.equal(o1, o2) and torch.equal(m1, m2) and torch.equal(v1, v2)
    assert _rel(g2, g1) < 2e-2


def test_sum_sq_f32_takes_squares_in_f32():
    """The batch statistics' sum of squares of bf16 values: every square in
    f32 (exact for bf16), as XLA computes ``jnp.sum(x * x, dtype=f32)``
    under jit, summed a slice of the leading axis at a time (f32 sums in
    another order than numpy's f64: rtol 1e-6); the gradient is
    ``2 x g`` rounded to bf16 once."""
    x = _t(np.random.RandomState(8).randn(3, 700, 5, 16).astype(np.float32) * 3)
    x64 = x.double().numpy()
    got = tfb.sum_sq_f32(x.requires_grad_(), (0, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), (x64 * x64).sum((0, 1, 2)), rtol=1e-6)
    g = torch.linspace(-1.0, 1.0, 16)
    got.backward(g)
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, (x.detach() * (2.0 * g).to(BF16)))
    f = torch.from_numpy(np.random.RandomState(9).randn(4, 6).astype(np.float32))
    assert torch.equal(tfb.sum_sq_f32(f, (0,)), (f * f).sum(dim=0))


def test_kernel_wrappers_refuse_cpu_tensors():
    src, query, W, nn = _mk()
    g = _t(np.einsum("bnc,cd->bnd", src, W))
    h = _t(np.einsum("bmc,cd->bmd", query, W))
    nn_t = torch.from_numpy(nn)
    before = (tfb.LAUNCHES, tfb.ROUTED_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.builder_core_cuda(g, h, nn_t)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.routed_dw_cuda(_t(src), nn_t, torch.zeros(h.shape, dtype=torch.int32), h, h)
    assert (tfb.LAUNCHES, tfb.ROUTED_LAUNCHES) == before
