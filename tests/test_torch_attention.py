"""Parity of the port's attention (pointcloudmatters_tpu_torch/ops) with the
JAX package's ``make_oneshot_attention_fn()`` path, f32, on the CPU (where
the JAX path runs its dense formulation and the port its plain versions).

Tolerance atol 1e-5: both sides are f32 softmax attention over unit-scale
inputs; only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops.attention import make_oneshot_attention_fn as jax_fn
from pointcloudmatters_tpu_torch.ops import attention as tatt
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone

ATOL = 1e-5


def _qkv(seed, B, Lq, Lk, H, dh):
    """(B, L, H, dh) f32 query/key/value, the layout attention_fn takes."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, H, dh).astype(np.float32),
            rng.randn(B, Lk, H, dh).astype(np.float32),
            rng.randn(B, Lk, H, dh).astype(np.float32))


def _jax(q, k, v, mask=None):
    out = jax_fn()(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   mask=None if mask is None else jnp.asarray(mask),
                   deterministic=True)
    return np.asarray(out)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("Lq,Lk", [(100, 100), (600, 600), (100, 600), (600, 130)])
@pytest.mark.parametrize("dh", [64, 128])
def test_dispatcher_matches_jax(Lq, Lk, dh):
    # Lk >= 512 takes the oneshot route, shorter key rows the dense math
    q, k, v = _qkv(Lq + Lk + dh, 2, Lq, Lk, 2, dh)
    got = tatt.make_oneshot_attention_fn()(*_t(q, k, v))
    assert got.shape == (2, Lq, 2, dh)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v), atol=ATOL, rtol=0)


@pytest.mark.parametrize("Lq,Lk", [(100, 100), (64, 600)])
def test_oneshot_plain_matches_jax(Lq, Lk):
    q, k, v = _qkv(Lq * Lk, 2, Lq, Lk, 3, 64)
    got = tone.oneshot_attention(
        *[t.transpose(1, 2) for t in _t(q, k, v)], 64 ** -0.5)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), _jax(q, k, v),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("Lk,pad", [(600, 40), (515, 125)])
def test_l_actual_masks_padded_keys(Lk, pad):
    """Keys padded with junk on the port's side, masked by l_actual, against
    the unpadded JAX call."""
    q, k, v = _qkv(Lk + pad, 2, 70, Lk, 2, 64)
    junk = np.random.RandomState(pad).randn(2, pad, 2, 64).astype(np.float32) * 50
    kp, vp = np.concatenate([k, junk], 1), np.concatenate([v, junk], 1)
    got = tone.oneshot_attention(
        *[t.transpose(1, 2) for t in _t(q, kp, vp)], 64 ** -0.5, l_actual=Lk)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), _jax(q, k, v),
                               atol=ATOL, rtol=0)


def test_key_padding_mask_goes_dense():
    q, k, v = _qkv(9, 2, 40, 600, 2, 64)
    mask = np.ones((2, 1, 1, 600), bool)
    mask[1, ..., 450:] = False
    got = tatt.make_oneshot_attention_fn()(*_t(q, k, v),
                                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, mask), atol=ATOL, rtol=0)


def test_dropout_raises():
    """Dropout needs the step's random streams and a rate in [0, 1); at
    deterministic=True the rate is ignored, as in JAX."""
    q, k, v = _t(*_qkv(1, 1, 8, 600, 1, 64))
    with pytest.raises(ValueError, match="rngs"):
        tatt.make_oneshot_attention_fn()(q, k, v, dropout_rate=0.1,
                                         deterministic=False)
    with pytest.raises(ValueError, match="rngs"):
        tatt.dot_product_attention(q, k, v, dropout_rate=0.1, deterministic=False)
    with pytest.raises(ValueError, match="rate"):
        tone.oneshot_attention(*[t.transpose(1, 2) for t in (q, k, v)], 0.125,
                               rate=1.0)
    got = tatt.make_oneshot_attention_fn()(q, k, v, dropout_rate=0.1,
                                           deterministic=True)
    np.testing.assert_allclose(got.numpy(), _jax(*(t.numpy() for t in (q, k, v))),
                               atol=ATOL, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = [t.transpose(1, 2) for t in _t(*_qkv(2, 1, 8, 8, 1, 64))]
    before = tone.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tone.oneshot_attention_cuda(q, k, v, 0.125)
    assert tone.LAUNCHES == before
