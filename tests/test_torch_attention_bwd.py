"""The port's attention backward and dropout masks, f32, on the CPU.

- The oneshot autograd function (plain forward and backward on the CPU)
  against ``jax.grad`` through the JAX package's ``make_oneshot_attention_fn``
  at rate 0 (which runs its dense formulation off the TPU), atol 1e-5: both
  are f32 softmax attention gradients over unit-scale inputs, only the
  summation order differs.
- At rate 0.1, ``oneshot_attention_plain_bwd`` against torch autograd of the
  dense math with the same explicit keep mask, atol 1e-5.
- The Philox keep mask: Random123's known-answer vectors, its sharing
  structure (one mask per head, shared across the batch), purity in
  (seed, head, row, column), and its keep fraction within 5 sigma.
- The dense route's broadcast dropout and ``BitsDropout``'s quantised rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops.attention import make_oneshot_attention_fn as jax_fn
from pointcloudmatters_tpu_torch.models.components.nn_utils import BitsDropout
from pointcloudmatters_tpu_torch.ops import attention as tatt
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone

ATOL = 1e-5
M32 = 0xFFFFFFFF
# Random123 Philox4x32-10 known answers: counter, key -> output
KAT = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([M32] * 4, [M32] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("Lq,Lk,pad", [(70, 600, 0), (130, 90, 0), (64, 515, 37)])
def test_backward_matches_jax_grad(Lq, Lk, pad):
    """dQ/dK/dV of the port's autograd function against jax.grad at rate 0,
    Lq != Lk; with ``pad`` the port's keys carry junk masked by l_actual
    (their gradients must be 0)."""
    B, H, dh = 2, 3, 64
    q, k, v, g = _arrays(Lq + Lk, (B, Lq, H, dh), (B, Lk, H, dh), (B, Lk, H, dh),
                         (B, Lq, H, dh))

    def jloss(q, k, v):
        return jnp.sum(jax_fn()(q, k, v, deterministic=True) * g)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    junk = np.random.RandomState(pad).randn(B, pad, H, dh).astype(np.float32) * 50
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(np.concatenate([k, junk], 1)).requires_grad_()
    tv = torch.from_numpy(np.concatenate([v, junk], 1)).requires_grad_()
    out = tone.oneshot_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                 tv.transpose(1, 2), dh ** -0.5, l_actual=Lk)
    out.transpose(1, 2).backward(torch.from_numpy(g))
    for name, got, want in (("dq", tq.grad, ref[0]), ("dk", tk.grad, ref[1]),
                            ("dv", tv.grad, ref[2])):
        np.testing.assert_allclose(got[:, :got.shape[1] - pad if name != "dq" else None]
                                   .numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert not tk.grad[:, Lk:].any() and not tv.grad[:, Lk:].any()


@pytest.mark.parametrize("l_actual", [None, 77])
def test_plain_backward_with_dropout_matches_autograd(l_actual):
    """``oneshot_attention_plain_bwd`` at rate 0.1 against torch autograd of
    ``softmax(s) * keep / (1 - rate) @ v`` with the same explicit mask."""
    B, H, Lq, Lk, dh, rate, seed = 2, 3, 50, 90, 64, 0.1, 99
    q, k, v = [torch.from_numpy(a).requires_grad_() for a in _arrays(
        5, (B, H, Lq, dh), (B, H, Lk, dh), (B, H, Lk, dh))]
    (dout,) = [torch.from_numpy(a) for a in _arrays(6, (B, H, Lq, dh))]
    n = Lk if l_actual is None else l_actual
    keep = tone.keep_mask(seed, rate, H, Lq, Lk)
    s = (q * dh ** -0.5) @ k.transpose(-1, -2)
    s = torch.where(torch.arange(Lk) < n, s, tone.NEG_INF)
    ref = (torch.softmax(s, -1) * keep / (1 - rate)) @ v
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)

    with torch.no_grad():
        out, m, r = tone.oneshot_attention_plain(q, k, v, dh ** -0.5, l_actual, rate,
                                                 seed, with_stats=True)
        got = tone.oneshot_attention_plain_bwd(q, k, v, out, dout, m, r, dh ** -0.5,
                                               l_actual, rate, seed)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=ATOL, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("counter,key,expected", KAT)
def test_philox_known_answers(counter, key, expected):
    words = tone.philox4x32_10(counter, key)
    assert [int(w) for w in words] == expected


def test_mask_shared_across_batch_distinct_across_heads():
    """q = 0 and v = I read the mask back out of the plain forward: every
    batch row sees the same mask, and the heads differ."""
    B, H, Lq, n, rate = 3, 4, 40, 32, 0.25
    q = torch.zeros(B, H, Lq, n)
    k = torch.from_numpy(_arrays(1, (B, H, n, n))[0])
    v = torch.eye(n).expand(B, H, n, n)
    out = tone.oneshot_attention(q, k, v, 1.0, rate=rate, seed=5)
    read = torch.round(out * (n * (1 - rate))).to(torch.bool)
    assert torch.equal(read, tone.keep_mask(5, rate, H, Lq, n).expand(B, H, Lq, n))
    assert all(torch.equal(read[0], read[b]) for b in range(B))
    assert not any(torch.equal(read[0, 0], read[0, h]) for h in range(1, H))


def test_mask_is_pure_in_seed_head_row_column():
    full = tone.keep_mask(1234, 0.1, 4, 64, 203)
    assert torch.equal(full[:, 17:40], tone.keep_mask(1234, 0.1, 4, 23, 203, row0=17))
    assert torch.equal(full[:, :, :101], tone.keep_mask(1234, 0.1, 4, 64, 101))
    assert torch.equal(full[:2], tone.keep_mask(1234, 0.1, 2, 64, 203))
    assert torch.equal(full, tone.keep_mask(1234, 0.1, 4, 64, 203))
    assert not torch.equal(full, tone.keep_mask(1235, 0.1, 4, 64, 203))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_keep_fraction(rate):
    mask = tone.keep_mask(7, rate, 8, 256, 256)
    n = mask.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(mask.float().mean().item() - (1 - rate)) < 5 * sigma


def test_dense_dropout_is_shared_across_batch_and_heads():
    """flax broadcast_dropout: one (Lq, Lk) mask for every batch row and
    head, survivors scaled by 1/(1 - rate)."""
    B, H, L, rate = 3, 4, 24, 0.3
    q = torch.zeros(B, L, H, L)
    k = torch.from_numpy(_arrays(2, (B, L, H, L))[0])
    v = torch.eye(L)[None, :, None, :].expand(B, L, H, L)
    rngs = {"dropout": torch.Generator().manual_seed(0),
            "seed": torch.Generator().manual_seed(1)}
    out = tatt.dot_product_attention(q, k, v, dropout_rate=rate, deterministic=False,
                                     rngs=rngs)
    read = out * (L * (1 - rate))  # (B, Lq, H, Lk): keep bits
    assert torch.allclose(read, torch.round(read), atol=1e-5)
    ref = read[0, :, 0]
    assert all(torch.equal(read[b, :, h], ref) for b in range(B) for h in range(H))
    assert 0 < ref.mean().item() < 1


def test_bits_dropout_rate():
    """rate 0.1 quantises to 26/256: keep (256 - 26)/256 within 5 sigma,
    survivors scaled by 256/230."""
    x = torch.ones(64, 1024)
    y = BitsDropout(0.1)(x, deterministic=False, generator=torch.Generator().manual_seed(3))
    p = (256 - 26) / 256
    kept = y != 0
    assert abs(kept.float().mean().item() - p) < 5 * np.sqrt(p * (1 - p) / x.numel())
    assert torch.allclose(y[kept], torch.full_like(y[kept], 256 / 230))
    assert torch.equal(BitsDropout(0.1)(x, deterministic=True), x)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = [torch.zeros(1, 1, 8, 64) for _ in range(3)]
    stats = torch.zeros(1, 1, 8)
    before = tone.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tone.oneshot_attention_bwd_cuda(q, k, v, q, q, stats, stats, 0.125)
    assert tone.BWD_LAUNCHES == before
