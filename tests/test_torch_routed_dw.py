"""Kernel 6, the routed dW of the data-source builder's backward
(``csrc/fused_builder.cu`` ``routed_dw_kernel``), emulated in numpy on the
CPU, and the gap between the TPU kernel and the reference it is held to.

The kernel computes ``dW = A^T W`` over the B*M*K gathered source rows on
the bf16 tensor cores. The emulation follows its arithmetic:

- the rows gathered at a pitch of a multiple of 8 channels (the padded
  copy of ``pad_channels``), holes and rows past a split zero; the
  channels between Cin and the next multiple of 8 hold whatever the pitch
  holds (junk here) and reach only dW rows that are not stored;
- the weights w = bit_max dvx + bit_min dvn in f32, as the plain version
  forms them, fed as w_hi = bf16(w) and w_lo = bf16(w - w_hi) (0 where w is
  not finite); the w_lo product only in a (block, stage) tile where some
  w_lo of the tile's 128 columns is not 0;
- splits of the (b, m) pairs (a multiple of 4 pairs each), stages of 4
  pairs (4 K rows padded to a multiple of 16), 16-row k steps whose
  products are summed exactly and added truncating (toward zero, as the
  tensor cores add) into a zeroed f32 sum, w_lo's before w_hi's, flushed
  into the f32 accumulator rounding to nearest every ``flush`` stages (the
  kernel's ``kFlush``); the splits' partials summed in split order.

Checked: the emulation against ``routed_dw_plain`` and JAX's
``_routed_dw_xla`` within 1e-5 * max|dW| (the gate of ``chip_smoke.py``
phase 3) on holes, all-hole queries, duplicate neighbours,
one-live-neighbour queries and Cin not a multiple of 16; w_hi + w_lo
against the f32 w of bf16 pairs (exact where w has at most 16 significant
bits, within 2^-16 |w| otherwise); the tile skip bit-exact; the flush
interval against a long same-signed sum, which one flush at the end pushes
past the gate; the split chooser, the constants and the C entries' argtypes
against the source.

Last, the TPU kernel itself (``_routed_dw_pallas``, in Pallas interpret
mode as the JAX package's tests run Pallas on the CPU) rounds w to bf16
(``fused_builder.py:351-353``), where its reference ``_routed_dw_xla`` and
the port keep f32: the two agree within 1e-5 * max|dW| where no neighbour
holds both tie bits, and within 2^-8 of the doubly tied terms where some do.
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

from pointcloudmatters_tpu.ops import fused_builder as jfb
from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import fused_builder as tfb

SOURCE = os.path.join(_build.CSRC, "fused_builder.cu")
BF16 = torch.bfloat16


def _consts() -> dict:
    with open(SOURCE) as f:
        return {k: v for k, v in re.findall(r"constexpr (?:int|float) (k\w+) = ([^;]+);", f.read())}


C = _consts()
TC, TD, PAIRS = int(C["kTC"]), int(C["kTD"]), int(C["kPairs"])


def bf16(x) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), held as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def rz(x: np.ndarray) -> np.ndarray:
    """f64 values to f32 rounding toward zero, as an mma adds into its
    accumulator."""
    r = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def routed_weights(bm, dvx, dvn, K):
    """(B, M, K, D) f32 w as the plain version and the kernel form it."""
    k = np.arange(K)[None, None, :, None]
    b = bm[:, :, None, :].astype(np.int64)
    mx = ((b >> k) & 1).astype(np.float32)
    mn = ((b >> (16 + k)) & 1).astype(np.float32)
    with np.errstate(invalid="ignore"):
        return mx * dvx[:, :, None, :] + mn * dvn[:, :, None, :]


def split_weights(w):
    """(w_hi, w_lo): bf16(w) and bf16(w - w_hi), w_lo 0 where w is not finite."""
    hi = bf16(w)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(w), bf16(w - hi), np.float32(0))
    return hi, lo


def pairs_per_split(n_pairs: int, splits: int) -> int:
    """The C entry's split of the pairs: a multiple of the stage's pairs."""
    return -(-(-(-n_pairs // splits)) // PAIRS) * PAIRS


def emulate_routed_dw(src, nn, bm, dvx, dvn, splits, flush, junk=np.nan, skip=True,
                      stats=None):
    """Kernel 6's dW (Cin, D) f32 of src (B, N, Cin), nn (B, M, K), bm (B, M,
    D) int32, dvx, dvn (B, M, D), all values bf16 held as f32, the stage sums
    flushed every ``flush`` stages (0: only at the end). ``junk`` fills
    channels Cin .. ceil8(Cin) - 1 of every row; ``skip=False`` runs the w_lo
    product in every tile; ``stats`` gets the tiles that ran it."""
    B, N, Cin = src.shape
    _, M, K = nn.shape
    D = bm.shape[2]
    n_ct, n_dt = -(-Cin // TC), -(-D // TD)
    Cp = n_ct * TC
    srcp = np.zeros((B, N, Cp), np.float32)
    srcp[..., :Cin] = src
    srcp[..., Cin:-(-Cin // 8) * 8] = junk
    rows = np.where((nn >= 0)[..., None],
                    srcp[np.arange(B)[:, None, None], np.maximum(nn, 0)], np.float32(0))
    A = rows.reshape(B * M * K, Cp).astype(np.float64)
    hi, lo = split_weights(routed_weights(bm, dvx, dvn, K))
    whi = hi.reshape(B * M * K, D).astype(np.float64)
    wlo = lo.reshape(B * M * K, D).astype(np.float64)
    n_pairs, pps = B * M, pairs_per_split(B * M, splits)
    steps = -(-(PAIRS * K) // 16)
    lo_tiles = tiles = 0
    out = np.zeros((Cin, D), np.float32)
    for s in range(splits):
        p0, p1 = s * pps, min((s + 1) * pps, n_pairs)
        acc = np.zeros((Cp, D), np.float32)
        t = np.zeros((Cp, D), np.float32)
        since = 0
        for ps in range(p0, p1, PAIRS):
            r0, r1 = ps * K, min(ps + PAIRS, p1) * K
            a = np.zeros((steps * 16, Cp))
            wh = np.zeros((steps * 16, D))
            wl = np.zeros((steps * 16, D))
            a[:r1 - r0], wh[:r1 - r0], wl[:r1 - r0] = A[r0:r1], whi[r0:r1], wlo[r0:r1]
            # the vote of each column tile (every channel tile votes alike)
            vote = np.repeat([(wl[:, c:c + TD] != 0).any() or not skip
                              for c in range(0, n_dt * TD, TD)], TD)[:D]
            tiles += n_ct * n_dt
            lo_tiles += n_ct * int(vote[::TD].sum())
            with np.errstate(invalid="ignore"):
                for kk in range(steps):
                    ks = slice(16 * kk, 16 * kk + 16)
                    if vote.any():
                        t[:, vote] = rz(t[:, vote] + a[ks].T @ wl[ks][:, vote])
                    t = rz(t + a[ks].T @ wh[ks])
            since += 1
            if since == flush:
                acc = (acc.astype(np.float64) + t).astype(np.float32)
                t[:] = 0
                since = 0
        part = (acc.astype(np.float64) + t).astype(np.float32)[:Cin]
        out = (out.astype(np.float64) + part).astype(np.float32)
    if stats is not None:
        stats.update(lo_tiles=lo_tiles, tiles=tiles)
    return out


def _inputs(seed, B=2, N=300, M=48, K=16, D=256, Cin=40, one_live=True):
    """bf16 src, nn with holes (all-hole queries, partial holes, duplicate
    neighbours and, with ``one_live``, queries with one live neighbour), the
    plain core's tie bitmap, bf16 cotangents."""
    rng = np.random.RandomState(seed)
    src = bf16(rng.randn(B, N, Cin) * 0.5)
    W = rng.randn(Cin, D) * Cin ** -0.5
    nn = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn[:, -5:, :] = -1                 # all-hole queries
    nn[:, 10:20, K // 2:] = -1         # partial holes
    nn[0, 3, 2:] = nn[0, 3, 0]         # duplicate neighbours: exact ties
    if one_live:
        nn[:, 25:29, 1:] = -1          # one live neighbour: both tie bits on it
    g = torch.from_numpy(src @ W).to(BF16)
    h = torch.from_numpy(src[:, :M] @ W * 0.3).to(BF16)
    bm = tfb.builder_core_plain(g, h, torch.from_numpy(nn))[3].numpy()
    dvx, dvn = (bf16(rng.randn(B, M, D)) for _ in range(2))
    return src, nn, bm, dvx, dvn


def _plain(src, nn, bm, dvx, dvn):
    return tfb.routed_dw_plain(torch.from_numpy(src).to(BF16), torch.from_numpy(nn),
                               torch.from_numpy(bm), torch.from_numpy(dvx).to(BF16),
                               torch.from_numpy(dvn).to(BF16)).numpy()


def _xla(src, nn, bm, dvx, dvn):
    """JAX's ``_routed_dw_xla`` on the same inputs (its (B, K, Ci, M)
    layout, hole rows zero)."""
    gathered = np.stack([src[b][np.maximum(nn[b], 0)] for b in range(nn.shape[0])])
    inpg = np.where((nn < 0)[..., None], 0.0, gathered)
    return np.asarray(jfb._routed_dw_xla(
        jnp.asarray(inpg.transpose(0, 2, 3, 1), jnp.bfloat16),
        jnp.asarray(bm.transpose(0, 2, 1)),
        jnp.asarray(dvx.transpose(0, 2, 1), jnp.bfloat16),
        jnp.asarray(dvn.transpose(0, 2, 1), jnp.bfloat16)))


def _within_gate(got, ref):
    err = np.abs(got - ref).max()
    limit = 1e-5 * np.abs(ref).max()
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("Cin,K,splits", [(40, 16, 3), (131, 16, 2), (16, 16, 1), (9, 5, 4),
                                          (200, 4, 5)])
def test_emulation_matches_plain_and_jax_xla(Cin, K, splits):
    # Cin 40, 131, 9 and 200: not multiples of 16 (131 and 9 not of 8);
    # 200 and 131 span two channel tiles; K = 5 pads a stage to 32 rows
    src, nn, bm, dvx, dvn = _inputs(Cin * 7 + K, Cin=Cin, K=K)
    stats = {}
    got = emulate_routed_dw(src, nn, bm, dvx, dvn, splits, tfb.ROUTED_FLUSH, stats=stats)
    assert np.isfinite(got).all()  # the junk channels reach no stored entry
    _within_gate(got, _plain(src, nn, bm, dvx, dvn))
    _within_gate(got, _xla(src, nn, bm, dvx, dvn))
    assert 0 < stats["lo_tiles"] < stats["tiles"]  # the one-live-neighbour stages


def test_w_hi_plus_w_lo_holds_w():
    rng = np.random.RandomState(1)
    # bf16 pairs at every exponent gap up to 30, both signs
    a = bf16(rng.randn(20000) * np.exp2(rng.randint(-30, 30, 20000)))
    b = bf16(rng.randn(20000) * np.exp2(rng.randint(-30, 30, 20000)))
    w = a + b  # f32, as the plain version sums dvx + dvn
    hi, lo = split_weights(w)
    got = hi.astype(np.float64) + lo.astype(np.float64)
    mant = (w.view(np.uint32) & 0x7FFFFF) | 0x800000
    bits = 24 - np.array([(int(m) & -int(m)).bit_length() - 1 for m in mant])
    exact = bits <= 16
    assert exact.mean() > 0.3 and (~exact).mean() > 0.1
    np.testing.assert_array_equal(got[exact], w[exact].astype(np.float64))
    assert (np.abs(got - w) <= np.exp2(-16) * np.abs(w)).all()
    # a single bf16 value (one tie bit) needs no w_lo
    hi1, lo1 = split_weights(a)
    assert (hi1 == a).all() and (lo1 == 0).all()
    # w not finite: w_lo 0, w_hi carries it
    hi2, lo2 = split_weights(np.array([np.inf, -np.inf, np.nan], np.float32))
    assert (lo2 == 0).all() and np.isinf(hi2[:2]).all() and np.isnan(hi2[2])


def test_tile_skip_is_exact():
    src, nn, bm, dvx, dvn = _inputs(5, Cin=40)
    skip, full = {}, {}
    got = emulate_routed_dw(src, nn, bm, dvx, dvn, 2, 1, stats=skip)
    every = emulate_routed_dw(src, nn, bm, dvx, dvn, 2, 1, skip=False, stats=full)
    np.testing.assert_array_equal(got.view(np.int32), every.view(np.int32))
    assert skip["lo_tiles"] < full["lo_tiles"] == full["tiles"]
    # no neighbour with both bits: no tile runs the w_lo product
    src, nn, bm, dvx, dvn = _inputs(6, Cin=40, one_live=False)
    none = {}
    emulate_routed_dw(src, nn, bm, dvx, dvn, 2, 1, stats=none)
    assert none["lo_tiles"] == 0


def test_flush_interval_keeps_a_long_sum_inside_the_gate():
    # one split of 16,384 rows of same-signed products (ReLU-like sources,
    # positive cotangents): added straight into the running sum, the k steps'
    # truncation shrinks it past 1e-5; flushed every ROUTED_FLUSH stages it
    # stays an f32 sum
    rng = np.random.RandomState(2)
    B, N, M, K, D, Cin = 1, 4096, 1024, 16, 16, 16
    src = bf16(np.abs(rng.randn(B, N, Cin)))
    nn = rng.randint(0, N, (B, M, K)).astype(np.int32)
    bm = (1 << rng.randint(0, K, (B, M, D))) | (1 << (16 + rng.randint(0, K, (B, M, D))))
    bm = bm.astype(np.int32)
    dvx, dvn = (bf16(np.abs(rng.randn(B, M, D))) for _ in range(2))
    ref = np.einsum("rc,rd->cd", *(
        np.where((nn < 0)[..., None], 0, src[0][nn[0]]).reshape(-1, Cin).astype(np.float64),
        routed_weights(bm, dvx, dvn, K).reshape(-1, D).astype(np.float64)))
    top = np.abs(ref).max()
    flushed = np.abs(emulate_routed_dw(src, nn, bm, dvx, dvn, 1, tfb.ROUTED_FLUSH) - ref).max()
    at_end = np.abs(emulate_routed_dw(src, nn, bm, dvx, dvn, 1, 0) - ref).max()
    assert flushed <= 1e-6 * top, (flushed, top)
    assert at_end >= 1e-5 * top and at_end >= 10 * flushed, (at_end, flushed, top)


@pytest.mark.parametrize("B", [1, 2, 4, 32, 64])
@pytest.mark.parametrize("M", [1, 256, 2048])
def test_split_chooser_rule(B, M):
    splits = tfb.routed_dw_splits(B, M)
    assert splits % tfb.ROUTED_SPLIT_GROUP == 0 and splits <= 65535
    assert (splits // tfb.ROUTED_SPLIT_GROUP - 1) * tfb.ROUTED_SPLIT_PAIRS < B * M
    assert B * M <= splits // tfb.ROUTED_SPLIT_GROUP * tfb.ROUTED_SPLIT_PAIRS
    pps = pairs_per_split(B * M, splits)
    assert pps % PAIRS == 0 and splits * pps >= B * M > (splits - 1) * pps - PAIRS * splits
    with open(SOURCE) as f:
        text = f.read()
    assert ("a.pairs_per_split = ((a.n_pairs + splits - 1) / splits + kPairs - 1) / kPairs * "
            "kPairs;") in text


def test_split_chooser_at_the_flagship():
    # 20 tiles of dW a split: 660 blocks at B <= 16, 1320 at B = 32, whole
    # waves of one block an SM on 132 SMs
    assert [tfb.routed_dw_splits(B, 2048) for B in (1, 4, 16, 32)] == [33, 33, 33, 66]
    tiles = -(-515 // TC) * -(-512 // TD)
    assert tiles == 20 and all(tiles * tfb.routed_dw_splits(B, 2048) % 132 == 0
                               for B in (1, 4, 32))


def test_constants_match_the_source():
    assert (TC, TD, PAIRS) == (128, 128, 4)
    assert int(C["kMaxK"]) == tfb._MAX_K == 16
    assert C["kRoutedThreads"].replace(" ", "") == "2*kTD" and C["kLd"].replace(" ", "") == "128+8"
    assert int(C["kRing"]) >= 3  # the ring keeps this stage and the next in place
    assert int(C["kFlush"]) == tfb.ROUTED_FLUSH >= 1


def test_pad_channels_and_pitch():
    src = torch.from_numpy(bf16(np.random.RandomState(3).randn(2, 5, 515))).to(BF16)
    pad = tfb.pad_channels(src)
    assert pad.shape == (2, 5, 528) and pad.dtype == BF16
    assert torch.equal(pad[..., :515], src) and not pad[..., 515:].any()
    view = pad[..., :515]
    assert view.stride() == (5 * 528, 528, 1) and tfb._pitched(view)
    assert not tfb._pitched(src) and tfb._pitched(tfb.pad_channels(src[..., :512]))


def _prototype(name: str) -> list:
    """ctypes kinds of the parameters of ``int name(...)`` in the source."""
    with open(SOURCE) as f:
        text = f.read()
    match = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", text)
    assert match, f"no prototype of {name}"
    return [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in match.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("entry", ["pcm_routed_dw", "pcm_builder_fwd"])
def test_wrapper_argtypes_match_c_prototypes(monkeypatch, entry):
    class FakeLib:
        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            fn.argtypes = fn.restype = None
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda name: FakeLib())
    fn = getattr(tfb._lib(), entry)
    want = _prototype(entry)
    assert len(fn.argtypes) == len(want)
    for i, (got, kind) in enumerate(zip(fn.argtypes, want)):
        assert got is kind, f"{entry} argument {i}: {got.__name__} for {kind.__name__}"
    assert fn.restype is ctypes.c_int


class _Module(types.ModuleType):
    """A module with some attributes replaced."""

    def __init__(self, mod, **replaced):
        super().__init__(mod.__name__)
        self._mod = mod
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _pallas(src, nn, bm, dvx, dvn):
    """The TPU kernel in interpret mode, its inputs laid out as
    ``_builder_bwd_impl`` lays them out (M a multiple of 128)."""
    gathered = np.stack([src[b][np.maximum(nn[b], 0)] for b in range(nn.shape[0])])
    inpg = np.where((nn < 0)[..., None], 0.0, gathered)
    return np.asarray(jfb._routed_dw_pallas(
        jnp.asarray(inpg.transpose(0, 2, 3, 1), jnp.bfloat16),
        jnp.asarray(bm.transpose(0, 2, 1)),
        jnp.asarray(dvx.transpose(0, 2, 1), jnp.bfloat16),
        jnp.asarray(dvn.transpose(0, 2, 1), jnp.bfloat16)))


def test_tpu_kernel_rounds_w_where_one_neighbour_holds_both_bits(monkeypatch):
    monkeypatch.setattr(jfb, "pl", _Module(
        jfb.pl, pallas_call=functools.partial(jfb.pl.pallas_call, interpret=True)))
    # B=1, K=4, Ci=16, M=128, D=128: no neighbour with both bits, then some
    for one_live in (False, True):
        src, nn, bm, dvx, dvn = _inputs(11, B=1, N=200, M=128, K=4, D=128, Cin=16,
                                        one_live=one_live)
        got = _pallas(src, nn, bm, dvx, dvn)
        ref = _plain(src, nn, bm, dvx, dvn)
        k = np.arange(4)[None, None, :, None]
        both = ((bm[:, :, None, :] >> k) & (bm[:, :, None, :] >> (16 + k)) & 1).astype(bool)
        both &= (nn >= 0)[..., None]
        if not one_live:
            assert not both.any()
            _within_gate(got, ref)
            continue
        assert both.any()
        # |bf16(w) - w| <= 2^-9 |w| on each doubly tied term; bound each dW
        # entry by 2^-8 of those terms' sum of |src| |w|, plus the gate
        w = routed_weights(bm, dvx, dvn, 4)
        a = np.where((nn >= 0)[..., None], src[0][np.maximum(nn[0], 0)][None], 0.0)
        tied = np.where(both, np.abs(w), 0.0).reshape(-1, 128)
        bound = np.exp2(-8) * np.abs(a).reshape(-1, 16).T @ tied
        diff = np.abs(got - ref)
        assert (diff <= bound + 1e-5 * np.abs(ref).max()).all()
        assert diff.max() > 1e-5 * np.abs(ref).max()  # the gap is there
