"""The port's sparse-voxel ops (``pointcloudmatters_tpu_torch/ops/sparse.py``)
against the JAX package's (``pointcloudmatters_tpu/ops/sparse.py``), on the
CPU, on the same numpy inputs.

Coordinates come from ``tests/test_spunet.py``'s generator (two clouds, the
second with 10 padded slots), in three cases: ``unique``; ``duplicate``, a
valid voxel repeated at another slot; ``edge``, voxels at 0 and 1023, whose
neighbours fall outside ``[0, 1024)``. Limits: neighbour indices, ``rep``,
``new_valid`` and the parent coordinates bit-equal; f32 convolutions and
their gradients within 1e-5 of the largest reference entry (summation order
only); bf16 convolutions within 2e-2 of it (a bf16 ulp is 2^-8, and the
two frameworks order the f32 sums differently before the one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops import sparse as JS
from pointcloudmatters_tpu_torch.ops import sparse as TS
from test_spunet import make_sparse_batch

CASES = ("unique", "duplicate", "edge")
CI, CO = 5, 7


def _coords(case):
    d, _ = make_sparse_batch()
    gc = np.array(d["grid_coord"])
    valid = np.array(d["valid"])
    if case == "duplicate":
        gc[0, 5] = gc[0, 40]
        gc[1, 3] = gc[1, 77]
    elif case == "edge":
        gc[0, :6] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 5], [0, 1022, 1023],
                     [1022, 1023, 1023], [1, 1, 1]]
        gc[1, 140] = [0, 0, 0]  # in a padded slot: must be ignored
    return gc, valid


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """The inputs of one case, and JAX's answers for them, computed once."""
    gc, valid = _coords(request.param)
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 160, CI).astype(np.float32)
    cot = rng.randn(2, 160, CO).astype(np.float32)
    w = {k: rng.randn(k, CI, CO).astype(np.float32) for k in (8, 27, 125)}
    jgc, jvalid = jnp.asarray(gc), jnp.asarray(valid)
    ref = {"idx27": np.asarray(JS.neighbor_indices(jgc, jvalid, JS.kernel_offsets(3))),
           "idx125": np.asarray(JS.neighbor_indices(jgc, jvalid, JS.kernel_offsets(5))),
           "key": np.asarray(JS.linearize(jgc, jvalid)),
           "pool": [np.asarray(a) for a in JS.voxel_downsample(jgc, jvalid)]}
    rep = jnp.asarray(ref["pool"][1])
    ref["gather"] = np.asarray(JS.gather_neighbors(jnp.asarray(feat), jnp.asarray(ref["idx27"])))
    # level 1: the downsampled voxels, as SpUNet carries them
    coords1 = np.where(ref["pool"][2][..., None], ref["pool"][0], 0)
    ref["pool1"] = [np.asarray(a) for a in JS.voxel_downsample(
        jnp.asarray(coords1), jnp.asarray(ref["pool"][2]))]

    def subm(f, wt, idx):
        return jnp.sum(JS.submconv(f, wt, jnp.asarray(idx)) * cot)

    def down(f, wt):
        return jnp.sum(JS.strided_downconv(f, wt, jgc, rep, jvalid) * cot)

    def up(f, wt):
        return jnp.sum(JS.inverse_upconv(f, wt, jgc, rep, jvalid) * cot)

    jf = jnp.asarray(feat)
    for name, fn, wk, extra in (("subm27", subm, 27, (ref["idx27"],)),
                                ("subm125", subm, 125, (ref["idx125"],)),
                                ("down", down, 8, ()), ("up", up, 8, ())):
        out = {"subm27": lambda: JS.submconv(jf, jnp.asarray(w[27]), jnp.asarray(ref["idx27"])),
               "subm125": lambda: JS.submconv(jf, jnp.asarray(w[125]),
                                              jnp.asarray(ref["idx125"])),
               "down": lambda: JS.strided_downconv(jf, jnp.asarray(w[8]), jgc, rep, jvalid),
               "up": lambda: JS.inverse_upconv(jf, jnp.asarray(w[8]), jgc, rep, jvalid)}[name]
        ref[name] = np.asarray(out())
        grads = jax.grad(fn, argnums=(0, 1))(jf, jnp.asarray(w[wk]), *extra)
        ref[name + "_grad"] = [np.asarray(g) for g in grads]
    bf = jnp.bfloat16
    ref["subm27_bf16"] = np.asarray(JS.submconv(
        jf.astype(bf), jnp.asarray(w[27]).astype(bf), jnp.asarray(ref["idx27"])).astype(jnp.float32))
    ref["down_bf16"] = np.asarray(JS.strided_downconv(
        jf.astype(bf), jnp.asarray(w[8]).astype(bf), jgc, rep, jvalid).astype(jnp.float32))
    return dict(name=request.param, gc=gc, valid=valid, feat=feat, cot=cot, w=w, ref=ref)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, limit=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=limit * max(1e-30, np.abs(ref).max()))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_kernel_offsets(k):
    off = TS.kernel_offsets(k)
    np.testing.assert_array_equal(off, JS.kernel_offsets(k))
    if k % 2:  # centred: the plane K - 1 - k is the opposite offset
        np.testing.assert_array_equal(off[::-1], -off)


def test_linearize_and_neighbor_indices(case):
    gc, valid, ref = _t(case["gc"]), _t(case["valid"]), case["ref"]
    np.testing.assert_array_equal(TS.linearize(gc, valid).numpy(), ref["key"])
    for k, name in ((3, "idx27"), (5, "idx125")):
        idx = TS.neighbor_indices(gc, valid, TS.kernel_offsets(k))
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), ref[name])
    if case["name"] == "edge":  # the corner voxels see no neighbour outside the range
        assert (ref["idx27"][0, 1, 14:] == -1).all() and (ref["idx27"][0, 0, :13] == -1).all()
    assert (ref["idx27"][1, 150:] == -1).all()  # padded slots query nothing


def test_gather_neighbors(case):
    got = TS.gather_neighbors(_t(case["feat"]), _t(case["ref"]["idx27"]))
    np.testing.assert_array_equal(got.numpy(), case["ref"]["gather"])


def test_voxel_downsample_bit_equal(case):
    """Both levels SpUNet builds from the input: parent coordinates, ``rep``
    and ``new_valid`` bit-equal (the representative is the first child in
    stable sorted order, ties included)."""
    ref = case["ref"]
    got = TS.voxel_downsample(_t(case["gc"]), _t(case["valid"]))
    for g, r in zip(got, ref["pool"]):
        np.testing.assert_array_equal(g.numpy(), r)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    coords1 = torch.where(got[2][..., None], got[0], 0)
    for g, r in zip(TS.voxel_downsample(coords1, got[2]), ref["pool1"]):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("op", ["subm27", "subm125", "down", "up"])
def test_convolutions_and_gradients(case, op):
    """Forward within 1e-5 of the largest entry; d feat and d W against
    ``jax.grad`` within 1e-5 of theirs (duplicates included: the backward
    sums them onto the first slot, ops/sparse.py)."""
    ref, w = case["ref"], case["w"]
    gc, valid = _t(case["gc"]), _t(case["valid"])
    feat = _t(case["feat"]).requires_grad_()
    rep = _t(ref["pool"][1])
    if op.startswith("subm"):
        k = int(op[4:])
        weight = _t(w[k]).requires_grad_()
        out = TS.submconv(feat, weight, _t(ref[f"idx{k}"]))
    else:
        weight = _t(w[8]).requires_grad_()
        fn = TS.strided_downconv if op == "down" else TS.inverse_upconv
        out = fn(feat, weight, gc, rep, valid)
    _close(out, ref[op])
    (out * _t(case["cot"])).sum().backward()
    _close(feat.grad, ref[op + "_grad"][0])
    _close(weight.grad, ref[op + "_grad"][1])


def _plain_submconv(feat, weight, idx):
    """The JAX formulation in torch autograd: the stacked gather, one product."""
    B, N, K = idx.shape
    g = TS.gather_neighbors(feat, idx).reshape(B, N, -1)
    return g @ weight.reshape(-1, weight.shape[-1])


@pytest.mark.parametrize("k", [3, 5])
def test_submconv_grads_match_torch_autograd(case, k):
    """The autograd function's gradients against torch autograd through the
    plain stacked version (whose backward scatters); the symmetric gather
    (``max_dup=1``) alone where every voxel is unique."""
    idx = _t(case["ref"]["idx27" if k == 3 else "idx125"])
    cot = _t(case["cot"])
    runs = [_plain_submconv, TS.submconv]
    if case["name"] != "duplicate":
        runs.append(lambda f, w, i: TS.submconv(f, w, i, max_dup=1))
    grads = []
    for fn in runs:
        f, w = _t(case["feat"]).requires_grad_(), _t(case["w"][k ** 3]).requires_grad_()
        (fn(f, w, idx) * cot).sum().backward()
        grads.append((f.grad, w.grad))
    for f_grad, w_grad in grads[1:]:
        _close(f_grad, grads[0][0].numpy())
        _close(w_grad, grads[0][1].numpy())


def test_symmetric_gather_alone_misses_duplicates():
    """Why the input level sums duplicates: with a repeated voxel, the
    plain symmetric gather (``max_dup=1``) gives the repeat a gradient the
    forward does not have."""
    gc, valid = _coords("duplicate")
    idx = TS.neighbor_indices(_t(gc), _t(valid), TS.kernel_offsets(3))
    grads = []
    for md in (None, 1):
        f = torch.ones(2, 160, CI, requires_grad=True)
        TS.submconv(f, _t(np.ones((27, CI, CO), np.float32)), idx, md).sum().backward()
        grads.append(f.grad)
    assert (grads[0][0, 40] == 0).all() and (grads[1][0, 40] != 0).any()


@pytest.mark.parametrize("op", ["subm27", "down"])
def test_bf16_convolutions(case, op):
    """bf16 in and out, f32 sums rounded once (JAX's preferred_element_type)."""
    ref, w = case["ref"], case["w"]
    bf = torch.bfloat16
    feat = _t(case["feat"]).to(bf)
    if op == "subm27":
        out = TS.submconv(feat, _t(w[27]).to(bf), _t(ref["idx27"]))
    else:
        out = TS.strided_downconv(feat, _t(w[8]).to(bf), _t(case["gc"]), _t(ref["pool"][1]),
                                  _t(case["valid"]))
    assert out.dtype == bf
    _close(out, ref[op + "_bf16"], 2e-2)


def test_deterministic_across_runs(case):
    """Two runs of each op's forward and backward are bit-equal (no float
    atomics on any route; on the CPU this holds the code, the card run holds
    the kernels)."""
    w_up = np.random.RandomState(4).randn(8, CO, CO).astype(np.float32)

    def run():
        feat = _t(case["feat"]).requires_grad_()
        w27, w8 = _t(case["w"][27]).requires_grad_(), _t(case["w"][8]).requires_grad_()
        gc, valid, rep = _t(case["gc"]), _t(case["valid"]), _t(case["ref"]["pool"][1])
        down = TS.strided_downconv(feat, w8, gc, rep, valid)
        out = (TS.submconv(feat, w27, _t(case["ref"]["idx27"]))
               + TS.inverse_upconv(down, _t(w_up), gc, rep, valid))
        (out * _t(case["cot"])).sum().backward()
        return out.detach(), feat.grad, w27.grad, w8.grad
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
