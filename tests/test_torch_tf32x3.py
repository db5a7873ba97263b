"""The exact-f32 product of the port's f32 oneshot forward and backward and
f32 flash forward and backward (``csrc/f32_mma.cuh``, "3xTF32"), emulated
in numpy.

The card runs each f32 product as three TF32 tensor-core products: an
operand x is split into hi = rna(x) and lo = rna(x - hi), rna being
``cvt.rna.tf32.f32`` (10 mantissa bits, ties away from zero), and a b is
summed as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, one
``mma.m16n8k8`` (8-deep k step) at a time. The emulation
takes each k step's eight TF32 products exactly (in f64, where a product of
two 11-bit significands is exact), adds them truncating (toward zero, as
the tensor cores add into their accumulator) into a zeroed f32 sum, one
mma at a time, and adds that sum to the f32 accumulator rounding to
nearest, as the kernels' ``mma3`` does.

- rna rounds to 10 mantissa bits with ties away from zero, and hi + lo
  holds an operand to 2^-22 of its size.
- Over a long sum (P V over 2051 keys), adding the mmas straight into the
  accumulator lets their truncation shrink it step by step; the flushed sum
  stays within 4x of an f32 FMA chain's error.
- At dh 64 and 128, on operands drawn as ``chip_smoke.py`` phase 3 draws
  them (standard normal, q scaled by dh^-0.5), the emulated S = q k^T is
  within 4x of the error of a plain f32 product (an f32 FMA chain in k
  order, as the kernels it replaces summed) against f64; TF32 alone (hi
  only) is over 100x off, which is why it is not used.
- The emulated oneshot forward chain (``csrc/attention_fwd.cuh``): S =
  (q scale) K^T in 3xTF32 a 64-key tile at a time, keys at l_actual and
  beyond set to -1e30, the online softmax folded tile by tile (m_new =
  max(m, rowmax S), l <- l exp(m - m_new) + rowsum e, acc rescaled by the
  same factor), dropout on e, e_drop split for e_drop V, o = acc (1 / l),
  stays inside the 1e-4 * max(1, max |plain|) of ``chip_smoke.py`` against
  the same chain in f64 (itself the two-pass softmax to 1e-12), at dh 64
  and 128, rates 0 and 0.1, with and without a masked key tail; its row
  max and 1 / l, which the backward reads, within 1e-5 relative. Its
  tiles are f32_mma.cuh's, checked below.
- The emulated backward chain S -> p -> dP -> dS -> dQ, dK, dV stays
  inside the 1e-4 * max(1, max |plain|) that ``chip_smoke.py`` holds the
  kernels to, against the same chain in f64: the f32 oneshot backward's
  arithmetic (q pre-scaled, dQ scaled after), and the f32 flash
  backward's (a bias, the mask value added on a segment-masked key tail,
  sm_scale on the scores and in dS), dropout at 0 and 0.1.
- The f32 shared tiles (``at`` and ``ld`` of the header, read from the
  source) give every fragment load of the kernels 32 distinct banks a warp:
  the 8-byte row-major loads of A and B (conflict-free by half-warp) and
  the 4-byte transposed B loads.
"""

import os
import re

import numpy as np
import pytest

from pointcloudmatters_tpu_torch import _build

HEADER = os.path.join(_build.CSRC, "f32_mma.cuh")


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: x to 10 mantissa bits, ties away from zero
    (finite x; the magnitude is rounded up at half an ulp, in the bits)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, np.float32)
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def rz(x: np.ndarray) -> np.ndarray:
    """f64 values to f32 rounding toward zero, as an mma adds into its
    accumulator."""
    r = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def mma3(a: np.ndarray, b: np.ndarray, terms=("lh", "hl", "hh"), flush=True) -> np.ndarray:
    """a (M, K) times b (K, N) as the card sums it: per 8-deep k step, each
    TF32 product term's eight products summed exactly and added truncating
    into a zeroed f32 sum, which is added to the f32 accumulator rounding to
    nearest (``flush``, the kernels' ``mma3``); or each term added
    truncating into the accumulator itself."""
    (ah, al), (bh, bl) = split(a), split(b)
    parts = {"h": (ah, bh), "l": (al, bl)}
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        t = np.zeros_like(acc) if flush else acc
        for term in terms:
            pa, pb = parts[term[0]][0], parts[term[1]][1]
            t = rz(t.astype(np.float64) + pa[:, ks].astype(np.float64) @ pb[ks].astype(np.float64))
        acc = (acc.astype(np.float64) + t).astype(np.float32) if flush else t
    return acc


def fma_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a b in f32, summed in k order (the FP32-pipe kernels' sum)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a[:, k:k + 1].astype(np.float64) * b[k:k + 1].astype(np.float64)
               ).astype(np.float32)
    return acc


def test_rna_rounds_to_ten_bits_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    cases = {
        1.0 + 2.0 ** -11: 1.0 + 2.0 ** -10,        # a tie: away from zero
        -(1.0 + 2.0 ** -11): -(1.0 + 2.0 ** -10),
        1.0 + 2.0 ** -11 - 2.0 ** -20: 1.0,        # below the tie
        1.0 + 3 * 2.0 ** -11: 1.0 + 2 * 2.0 ** -10,  # a tie above an odd ulp
        2.0 - 2.0 ** -12: 2.0,                     # the carry into the exponent
    }
    for x, want in cases.items():
        assert rna_tf32(np.float32(x)) == np.float32(want), x
    assert rna_tf32(one + ulp) == one + ulp
    x = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi = rna_tf32(x)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(hi - x) <= np.abs(x) * 2.0 ** -11)


def test_split_holds_the_operand_to_2_pow_minus_22():
    x = np.random.RandomState(1).randn(100000).astype(np.float32) * 10.0 ** \
        np.random.RandomState(2).randint(-3, 4, 100000)
    hi, lo = split(x)
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(err <= np.abs(x) * 2.0 ** -22)


def _phase3_operands(dh, rows, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(rows, dh) * dh ** -0.5).astype(np.float32)
    k = rng.randn(rows, dh).astype(np.float32)
    return q, k


@pytest.mark.parametrize("dh", [64, 128])
def test_split_product_error_is_f32_like(dh):
    q, k = _phase3_operands(dh, 256, 3)
    ref = q.astype(np.float64) @ k.T.astype(np.float64)
    err3 = np.abs(mma3(q, k.T) - ref).max()
    err_fma = np.abs(fma_chain(q, k.T) - ref).max()
    err1 = np.abs(mma3(q, k.T, terms=("hh",)) - ref).max()
    assert err3 <= 4.0 * err_fma, (err3, err_fma)
    assert err1 >= 100.0 * err_fma, (err1, err_fma)


def test_flushed_sum_removes_the_truncation_bias():
    """A P V sum over 2051 keys: added straight into the accumulator, the
    mmas' truncation shrinks it step by step; flushed, the error is that of
    an f32 sum."""
    rng = np.random.RandomState(5)
    s = rng.randn(64, 2051)
    p = (np.exp(s - s.max(-1, keepdims=True)) * 0.5).astype(np.float32)
    v = rng.randn(2051, 64).astype(np.float32)
    ref = p.astype(np.float64) @ v.astype(np.float64)
    err_flush = np.abs(mma3(p, v) - ref).max()
    err_direct = np.abs(mma3(p, v, flush=False) - ref).max()
    err_fma = np.abs(fma_chain(p, v) - ref).max()
    assert err_flush <= 4.0 * err_fma, (err_flush, err_fma)
    assert err_direct >= 4.0 * err_flush, (err_direct, err_flush)


@pytest.mark.parametrize("dh,rate", [(64, 0.0), (64, 0.1), (128, 0.1)])
def test_split_backward_chain_within_kernel_limit(dh, rate):
    """S -> p -> dS -> dQ, dK, dV of the f32 oneshot backward, each product
    in emulated 3xTF32 and the rest in f32, against the chain in f64."""
    rng = np.random.RandomState(4)
    Lq, Lk = 96, 160
    q = rng.randn(Lq, dh).astype(np.float32)
    k, v = rng.randn(Lk, dh).astype(np.float32), rng.randn(Lk, dh).astype(np.float32)
    do = rng.randn(Lq, dh).astype(np.float32)
    scale = np.float32(dh ** -0.5)
    keep = rng.rand(Lq, Lk) >= rate
    inv_keep = np.float32(1.0 / (1.0 - rate))

    def chain(mm, f):
        qs = f(q) * f(scale)
        s = mm(qs, f(k).T)
        m = s.max(-1, keepdims=True)
        e = np.exp(s - m)
        p = e * (f(1.0) / e.sum(-1, keepdims=True))
        pd = np.where(keep, p * f(inv_keep), f(0.0))
        o = mm(pd, f(v))
        delta = (f(do) * o).sum(-1, keepdims=True)
        dp = mm(f(do), f(v).T)
        ds = p * (np.where(keep, dp * f(inv_keep), f(0.0)) - delta)
        return mm(ds, f(k)) * f(scale), mm(ds.T, qs), mm(pd.T, f(do))

    got = chain(mma3, np.float32)
    ref = chain(lambda a, b: a @ b, np.float64)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        limit = 1e-4 * max(1.0, np.abs(r).max())
        assert np.abs(g - r).max() <= limit, name


def oneshot_forward_chain(mm, f, q, k, v, scale, l_actual, keep, inv_keep, tile=64):
    """The f32 oneshot forward kernel's walk (``attention_fwd.cuh``) in the
    arithmetic ``f`` with the product ``mm``: o, the row max and 1 / l."""
    qs = f(q) * f(scale)
    Lq, dh = q.shape
    m = np.full((Lq, 1), -np.inf, qs.dtype)
    l = np.zeros((Lq, 1), qs.dtype)
    acc = np.zeros((Lq, dh), qs.dtype)
    for k0 in range(0, l_actual, tile):
        cols = np.arange(k0, k0 + tile)
        kt = np.zeros((tile, dh), k.dtype)
        vt = np.zeros((tile, dh), v.dtype)
        n = min(tile, k.shape[0] - k0)
        kt[:n], vt[:n] = k[k0:k0 + n], v[k0:k0 + n]
        s = mm(qs, f(kt).T)
        s = np.where(cols[None] < l_actual, s, f(-1.0e30))
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        e = np.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdims=True)
        kp = np.zeros((Lq, tile), bool)
        kp[:, :min(tile, keep.shape[1] - k0)] = keep[:, k0:k0 + tile]
        e_drop = np.where(kp, e * f(inv_keep), f(0.0))
        acc = acc * alpha + mm(e_drop, f(vt))
        m = m_new
    inv = f(1.0) / l
    return acc * inv, m[:, 0], inv[:, 0]


@pytest.mark.parametrize("dh,rate,tail", [(64, 0.0, False), (64, 0.1, False),
                                          (64, 0.1, True), (128, 0.0, True),
                                          (128, 0.1, False)])
def test_split_oneshot_forward_chain_within_kernel_limit(dh, rate, tail):
    """The f32 oneshot forward (kernel 3): each product in emulated 3xTF32
    and the online softmax in f32, against the same walk in f64, which is
    the two-pass softmax of the plain version."""
    rng = np.random.RandomState(7 + dh)
    Lq, Lk = 80, 200
    l_actual = 170 if tail else Lk
    q = rng.randn(Lq, dh).astype(np.float32)
    k, v = rng.randn(Lk, dh).astype(np.float32), rng.randn(Lk, dh).astype(np.float32)
    k[l_actual:] *= 1e3  # junk keys past l_actual
    scale = np.float32(dh ** -0.5)
    keep = rng.rand(Lq, Lk) >= rate
    inv_keep = np.float32(1.0 / (1.0 - rate))

    got = oneshot_forward_chain(mma3, np.float32, q, k, v, scale, l_actual, keep, inv_keep)
    ref = oneshot_forward_chain(lambda a, b: a @ b, np.float64, q, k, v, scale, l_actual,
                                keep, inv_keep)
    s = (q.astype(np.float64) * np.float64(scale)) @ k[:l_actual].T.astype(np.float64)
    e = np.exp(s - s.max(-1, keepdims=True))
    two_pass = (np.where(keep[:, :l_actual], e * np.float64(inv_keep), 0.0)
                @ v[:l_actual].astype(np.float64)) / e.sum(-1, keepdims=True)
    np.testing.assert_allclose(ref[0], two_pass, rtol=0, atol=1e-12)
    limit = 1e-4 * max(1.0, np.abs(ref[0]).max())
    assert np.abs(got[0] - ref[0]).max() <= limit
    for g, r in zip(got[1:], ref[1:]):  # the row max and 1 / l
        assert np.all(np.abs(g - r) <= 1e-5 * np.abs(r))


# flash's DEFAULT_MASK_VALUE as the kernels add it to an f32 score
MASK_VALUE = np.float32(-0.7 * float(np.finfo(np.float32).max))


@pytest.mark.parametrize("dh,rate", [(64, 0.0), (64, 0.1), (128, 0.0), (128, 0.1)])
def test_split_flash_backward_chain_within_kernel_limit(dh, rate):
    """The f32 flash backward (kernels 10 and 11): s = (q k^T + ab) sm_scale
    with q not pre-scaled, the mask value added on a segment-masked key
    tail, p = exp(s - m) (1 / l), dS = (dP D - di) p sm_scale, then
    dQ = dS k (no scale after), dK = dS^T q and dV = p_dropped^T do; each
    product in emulated 3xTF32 and the rest in f32, against the same chain
    in f64."""
    rng = np.random.RandomState(6)
    Lq, Lk = 96, 160
    q, do = rng.randn(Lq, dh).astype(np.float32), rng.randn(Lq, dh).astype(np.float32)
    k, v = rng.randn(Lk, dh).astype(np.float32), rng.randn(Lk, dh).astype(np.float32)
    ab = (rng.randn(Lq, Lk) * 0.5).astype(np.float32)
    masked = np.zeros((Lq, Lk), bool)
    masked[:, 130:] = True  # the keys' segment id differs from every query's
    sm_scale = np.float32(dh ** -0.5)
    keep = rng.rand(Lq, Lk) >= rate
    inv_keep = np.float32(1.0 / (1.0 - rate))

    def chain(mm, f):
        s = (mm(f(q), f(k).T) + f(ab)) * f(sm_scale)
        s = np.where(masked, s + f(MASK_VALUE), s)
        m = s.max(-1, keepdims=True)
        e = np.exp(s - m)
        p = e * (f(1.0) / e.sum(-1, keepdims=True))
        d = np.where(keep, f(inv_keep), f(0.0))
        pd = p * d
        di = (f(do) * mm(pd, f(v))).sum(-1, keepdims=True)
        ds = (mm(f(do), f(v).T) * d - di) * p * f(sm_scale)
        return mm(ds, f(k)), mm(ds.T, f(q)), mm(pd.T, f(do))

    got = chain(mma3, np.float32)
    ref = chain(lambda a, b: a @ b, np.float64)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        limit = 1e-4 * max(1.0, np.abs(r).max())
        assert np.abs(g - r).max() <= limit, name
    for g in got[1:]:  # the masked keys weigh exactly 0: no dK, dV
        assert np.all(g[130:] == 0.0)


def _tile_offset(dh: int):
    """``at<DH>(r, c)`` of the header as a Python function, from its source."""
    with open(HEADER) as f:
        text = f.read()
    ld = re.search(r"constexpr int ld\(\) \{\s*return (DH \+ \d+);", text).group(1)
    at = re.search(r"int at\(int r, int c\) \{\s*return ([^;]+);", text).group(1)
    width = eval(ld.replace("DH", str(dh)))
    expr = at.replace("ld<DH>()", str(width))
    return lambda r, c: eval(expr, {}, {"r": r, "c": c})


@pytest.mark.parametrize("dh", [64, 128])
def test_tile_fragment_loads_are_conflict_free(dh):
    at = _tile_offset(dh)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]  # (g, t)
    for r0 in (0, 16, 48, 112):  # 112: the last warp of a 128-row q tile
        for c0 in range(0, dh, 8):
            # row-major A/B: one 8-byte load of (row r0 + g, columns c0 + 2t, +1)
            for half in (lanes[:16], lanes[16:]):
                offs = [at(r0 + g, c0 + 2 * t) for g, t in half]
                assert all(o % 2 == 0 and at(r0 + g, c0 + 2 * t + 1) == o + 1
                           for o, (g, t) in zip(offs, half))
                assert len({(o % 32) // 2 for o in offs}) == 16
            # transposed B: 4-byte loads of rows c0 + 2t (+1), column r0 + g
            for extra in (0, 1):
                banks = {at(c0 + 2 * t + extra, r0 + g) % 32 for g, t in lanes}
                assert len(banks) == 32
