"""Kernel 5, the data-source builder's forward statistics
(``csrc/fused_builder.cu`` ``builder_fwd_kernel`` and ``sum_partials_kernel``),
emulated in numpy on the CPU.

The kernel gives a thread 8 consecutive channels of a query, a block of 256
threads QF queries at once, and the B*M queries in groups of QF to at most
``kFwdBlocks`` blocks, round robin. The emulation follows it:

- x = bf16(g - h) per channel pair (``sub.rn.bf16x2``: one rounding of the
  exact difference, which equals the f32 difference rounded once, checked
  here over every exponent gap); vmax and vmin over the live neighbours,
  the tie bits by comparing each live x with them (a hole compares as NaN);
  sg the f32 sum of the live gathered rows in k order;
- the totals: each thread's f32 sums of x and x * x over a query's
  neighbours in order, added to its running sums round by round (K +
  rounds terms deep), a block's query slots added in slot order into one
  row of partials, the rows summed by 128 interleaved runs, 4 runs a lane in
  order and the 32 lanes by a shuffle tree.

Held against ``builder_core_plain`` and JAX's ``_core_xla``
(``pointcloudmatters_tpu/ops/fused_builder.py:299``, the oracle of the TPU
kernel) with the tolerances of ``tests/test_torch_fused_builder.py``:
vmax, vmin and the tie bitmap bit-equal, sg within one bf16 ulp (and equal
to the k-order sum), the totals within 1e-4 of their largest entry; on
holes, all-hole queries, duplicate neighbours (exact ties) and
one-live-neighbour queries, at K in {1, 9, 16}, D in {128, 384, 512, 2064}
(16, 5, 4 and 1 queries a block; 2064 in two passes over the channels) and
M not a multiple of the queries a block. Also: every query served once by the
decomposition, its shapes at the flagship, the constants, the C entries'
prototypes and guards against the wrapper, and the wrapper's refusals.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.ops import fused_builder as jfb
from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import fused_builder as tfb

SOURCE = os.path.join(_build.CSRC, "fused_builder.cu")
BF16 = torch.bfloat16


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


C = dict(re.findall(r"constexpr int (k\w+) = (\d+);", _source()))
THREADS, MAX_QF = int(C["kFwdThreads"]), int(C["kMaxQF"])
BLOCKS, RUNS, MAX_K = int(C["kFwdBlocks"]), int(C["kSumRuns"]), int(C["kMaxK"])


def fwd_shape(queries: int, D: int) -> dict:
    """The source's ``FwdShape``: chunks of 8 channels, chunks a pass,
    queries a group (QF), passes, blocks and rounds a block."""
    chunks = D // 8
    per_pass = min(chunks, THREADS)
    qf = min(THREADS // per_pass, MAX_QF)
    groups = -(-queries // qf)
    blocks = min(groups, BLOCKS)
    return dict(chunks=chunks, per_pass=per_pass, qf=qf, passes=-(-chunks // per_pass),
                blocks=blocks, rounds=-(-groups // blocks))


def bf16(x) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), held as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def emulate_builder_fwd(g, h, nn):
    """Kernel 5's (vmax, vmin, sg, bm, total, total_sq) of g (B, N, D), h (B,
    M, D) (bf16 values held as f32) and nn (B, M, K), in numpy f32, with its
    threads, query groups, blocks and partial rows."""
    B, N, D = g.shape
    M, K = nn.shape[1], nn.shape[2]
    Q = B * M
    live = (nn >= 0).reshape(Q, K)
    rows = g[np.arange(B)[:, None, None], np.maximum(nn, 0)].reshape(Q, K, D)
    hq = h.reshape(Q, D)
    with np.errstate(invalid="ignore"):
        x = bf16(rows - hq[:, None, :])  # the f32 difference rounded once
    x = np.where(live[..., None], x, np.float32(np.nan))  # a hole: NaN
    f32 = np.float32
    vmax = np.full((Q, D), -np.inf, f32)
    vmin = np.full((Q, D), np.inf, f32)
    sg = np.zeros((Q, D), f32)
    for k in range(K):
        on = live[:, k, None]
        vmax = np.where(on, np.maximum(vmax, x[:, k]), vmax)
        vmin = np.where(on, np.minimum(vmin, x[:, k]), vmin)
        sg = np.where(on, sg + rows[:, k], sg).astype(f32)
    bm = np.zeros((Q, D), np.int64)
    for k in range(K):
        bm |= (x[:, k] == vmax).astype(np.int64) << k
        bm |= (x[:, k] == vmin).astype(np.int64) << (16 + k)
    # totals: thread (block, slot) over its rounds, then the slots, then the rows
    sh = fwd_shape(Q, D)
    nb, qf = sh["blocks"], sh["qf"]
    tot = np.zeros((nb, qf, D), f32)
    sq = np.zeros((nb, qf, D), f32)
    xz = np.where(live[..., None], x, f32(0))
    for r in range(sh["rounds"]):
        q = (r * nb + np.arange(nb))[:, None] * qf + np.arange(qf)[None, :]
        ok = q < Q
        tq = np.zeros((nb, qf, D), f32)  # the query's sums over k
        sqq = np.zeros((nb, qf, D), f32)
        for k in range(K):
            xk = np.where(ok[..., None], xz[np.minimum(q, Q - 1), k], f32(0))
            tq = (tq + xk).astype(f32)
            sqq = (sqq + xk * xk).astype(f32)  # x * x exact in f32: one rounding
        tot = (tot + tq).astype(f32)
        sq = (sq + sqq).astype(f32)
    part = np.zeros((nb, 2, D), f32)
    for i in range(qf):
        part[:, 0] = (part[:, 0] + tot[:, i]).astype(f32)
        part[:, 1] = (part[:, 1] + sq[:, i]).astype(f32)
    runs = np.zeros((RUNS, 2, D), f32)
    for u in range(RUNS):
        for i in range(u, nb, RUNS):
            runs[u] = (runs[u] + part[i]).astype(f32)
    lanes = runs[0::4].copy()  # lane l: runs 4l .. 4l + 3 in order
    for i in range(1, 4):
        lanes = (lanes + runs[i::4]).astype(f32)
    off = 16
    while off:  # the shuffle tree: lane l adds lane l + off
        lanes[:off] = (lanes[:off] + lanes[off:2 * off]).astype(f32)
        off //= 2
    totals = lanes[0]
    out = [a.reshape(B, M, D) for a in (vmax, vmin, bf16(sg))]
    bm32 = np.where(bm >= 2**31, bm - 2**32, bm).astype(np.int32).reshape(B, M, D)
    return out[0], out[1], out[2], bm32, totals[0], totals[1]


def _inputs(seed, B=2, N=300, M=250, K=16, D=128):
    """bf16 g and h (as f32) and nn with all-hole queries, partial holes,
    duplicate neighbours (exact ties) and one-live-neighbour queries."""
    rng = np.random.RandomState(seed)
    Cin = 9
    src = (rng.randn(B, N, Cin) * 0.4).astype(np.float32)
    query = (rng.randn(B, M, Cin) * 0.4).astype(np.float32)
    W = (rng.randn(Cin, D) * 0.3).astype(np.float32)
    nn = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn[:, -8:, :] = -1                  # all-hole (padding) queries
    nn[1, 7, ::2] = -1                  # partial holes
    if K > 1:
        nn[0, 3, K // 2:] = nn[0, 3, 0]  # duplicate neighbours: exact ties
        nn[:, 20:26, 1:] = -1           # one live neighbour: both tie bits on it
    nn[0, 40, :] = np.where(np.arange(K) % 3 == 0, nn[0, 40, :], -1)
    return bf16(src @ W), bf16(query @ W), nn


def _within_ulp(a, b) -> bool:
    """Each entry of ``a`` within one bf16 ulp of ``b``'s (inf equal)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(b)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b[fin]), 1e-30))) - 7)
    return bool(np.array_equal(a[~fin], b[~fin]) and (np.abs(a[fin] - b[fin]) <= ulp).all())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1e-30, np.abs(b).max()))


def _hold(got, ref, what):
    for name, a, b in zip(("vmax", "vmin"), got[:2], ref[:2]):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32), err_msg=f"{what} {name}")
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]), err_msg=f"{what} bm")
    assert _within_ulp(got[2], ref[2]), f"{what} sg"
    for a, b in zip(got[4:], ref[4:]):
        assert _rel(a, b) < 1e-4, what


@pytest.mark.parametrize("D", [128, 384, 512, 2064])
@pytest.mark.parametrize("K", [1, 9, 16])
def test_emulation_matches_plain_and_jax_core_xla(K, D):
    # D = 384 leaves a thread slot idle (5 queries a block), D = 2064 takes
    # two passes over the channels, the second 2 chunks wide (1 a block)
    g, h, nn = _inputs(K * 31 + D, M=253 if D == 384 else 250, K=K, D=D)
    M = nn.shape[1]
    qf = fwd_shape(2 * M, D)["qf"]
    assert qf == 1 or M % qf != 0  # the last group of a cloud is short
    got = emulate_builder_fwd(g, h, nn)
    plain = tfb.builder_core_plain(torch.from_numpy(g).to(BF16), torch.from_numpy(h).to(BF16),
                                   torch.from_numpy(nn))
    _hold(got, [t.float().numpy() if t.dtype == BF16 else t.numpy() for t in plain], "plain")
    xla = jax.jit(jfb._core_xla)(jnp.asarray(g, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
                                 jnp.asarray(nn))
    _hold(got, [np.asarray(t, np.float32) if t.dtype == jnp.bfloat16 else np.asarray(t)
                for t in xla], "jax")
    # the cases are exercised: all-hole queries have no tie bit and +-inf
    # extremes; one live neighbour holds both bits in every channel
    bm = got[3].view(np.uint32)
    assert (bm[:, -8:] == 0).all() and np.isneginf(got[0][:, -8:]).all()
    assert np.isposinf(got[1][:, -8:]).all()
    if K > 1:
        assert (bm[:, 20:26] == 0x10001).all()
        assert ((bm[0, 3] & 0xFFFF) != 0).all()


def test_sg_is_the_k_order_sum():
    g, h, nn = _inputs(3)
    got = emulate_builder_fwd(g, h, nn)
    B, M, K = nn.shape
    want = np.zeros((B, M, g.shape[2]), np.float32)
    for k in range(K):
        rows = g[np.arange(B)[:, None], np.maximum(nn[:, :, k], 0)]
        want = (want + np.where((nn[:, :, k] >= 0)[..., None], rows, 0)).astype(np.float32)
    np.testing.assert_array_equal(got[2], bf16(want))


def _bf16_rne(x64: np.ndarray) -> np.ndarray:
    """f64 values rounded once to bf16 (8 significant bits, ties to even)."""
    m, e = np.frexp(x64)
    return np.ldexp(np.round(np.ldexp(m, 8)), e - 8)


def test_bf16_difference_rounds_once():
    # the kernel's sub.rn.bf16x2 rounds the exact g - h once; the plain
    # version rounds the f32 difference: equal over every exponent gap
    rng = np.random.RandomState(0)
    n = 200000
    a = bf16(rng.randn(n) * np.exp2(rng.randint(-40, 40, n)))
    b = bf16(rng.randn(n) * np.exp2(rng.randint(-40, 40, n)))
    b[:1000] = a[:1000]  # equal operands: +0
    b[1000:2000] = np.nextafter(a[1000:2000], np.float32(np.inf))
    exact = _bf16_rne(a.astype(np.float64) - b.astype(np.float64))
    via_f32 = bf16(a - b)
    np.testing.assert_array_equal(via_f32.astype(np.float64), exact)
    assert (np.abs(np.log2(np.abs(a[2000:]) + 1e-45) - np.log2(np.abs(b[2000:]) + 1e-45))
            > 16).mean() > 0.2  # f32 rounds there: the case that needs the argument


@pytest.mark.parametrize("D", [8, 128, 384, 512, 2048, 2056, 4096])
@pytest.mark.parametrize("B,M", [(1, 1), (1, 2048), (2, 250), (4, 2048), (32, 2048), (64, 2048)])
def test_every_query_served_once(B, M, D):
    sh = fwd_shape(B * M, D)
    assert sh["per_pass"] * sh["qf"] <= THREADS and sh["qf"] <= MAX_QF
    assert sh["blocks"] <= BLOCKS and sh["passes"] * sh["per_pass"] >= sh["chunks"]
    assert (sh["passes"] - 1) * sh["per_pass"] < sh["chunks"]
    q = ((np.arange(sh["rounds"])[:, None, None] * sh["blocks"]
          + np.arange(sh["blocks"])[None, :, None]) * sh["qf"]
         + np.arange(sh["qf"])[None, None, :]).ravel()
    q = q[q < B * M]
    assert np.array_equal(np.sort(q), np.arange(B * M))
    # the last round has work: no block count or round is wasted
    assert (sh["rounds"] - 1) * sh["blocks"] * sh["qf"] < B * M


def test_decomposition_at_the_flagship():
    # D = 512: 64 threads a query, 4 queries a block; 264 blocks (one wave
    # at two an SM) of 2 rounds at B=1, 8 at B=4, 63 at B=32
    for B, blocks, rounds in ((1, 264, 2), (4, 264, 8), (32, 264, 63)):
        sh = fwd_shape(B * 2048, 512)
        assert (sh["per_pass"], sh["qf"], sh["passes"]) == (64, 4, 1)
        assert (sh["blocks"], sh["rounds"]) == (blocks, rounds), B
    assert fwd_shape(2048, 128)["qf"] == 16  # D = 128: 16 threads a query


def test_constants_match_the_source():
    text = _source()
    assert (THREADS, MAX_QF, BLOCKS, RUNS) == (256, 16, 264, 128)
    assert MAX_K == tfb._MAX_K == 16 and MAX_QF * MAX_K <= THREADS  # a round's nn: one copy a thread
    for line in ("per_pass = chunks < kFwdThreads ? chunks : kFwdThreads;",
                 "qf = kFwdThreads / per_pass < kMaxQF ? kFwdThreads / per_pass : kMaxQF;",
                 "blocks = (int)(groups < kFwdBlocks ? groups : kFwdBlocks);",
                 "rounds = (int)((groups + blocks - 1) / blocks);",
                 "const long long q = ((long long)r * gridDim.x + blockIdx.x) * sh.qf + slot;",
                 "for (int i = run; i < rows; i += kSumRuns) s += part[(long long)i * width + col];",
                 "for (int i = 1; i < 4; ++i) t += acc[4 * lane + i][warp];",
                 "for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);",
                 "return FwdShape((long long)B * M, D).blocks;"):
        assert line in text, line
    # the entry refuses what the kernel does not take
    guard = re.search(r"int pcm_builder_fwd\([^)]*\)\s*\{\s*if \(([^;]*)\)\s*return", text)
    assert guard, "no guard in pcm_builder_fwd"
    for term in ("K > kMaxK", "D % 8 != 0", "(uintptr_t)g % 16 != 0", "(uintptr_t)h % 16 != 0",
                 "(uintptr_t)vmax % 16 != 0", "(uintptr_t)vmin % 16 != 0",
                 "(uintptr_t)sg % 16 != 0", "(uintptr_t)bm % 16 != 0"):
        assert term in guard.group(1), term


def _prototype(name: str, ret: str) -> list:
    """ctypes kinds of the parameters of ``ret name(...)`` in the source."""
    match = re.search(r"\b" + ret + r"\s+" + name + r"\s*\(([^)]*)\)\s*\{", _source())
    assert match, f"no prototype of {name}"
    return [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in match.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("entry,ret,restype", [
    ("pcm_builder_fwd", "int", ctypes.c_int),
    ("pcm_builder_fwd_partials", "long long", ctypes.c_longlong)])
def test_wrapper_argtypes_match_c_prototypes(monkeypatch, entry, ret, restype):
    class FakeLib:
        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            fn.argtypes = fn.restype = None
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda name: FakeLib())
    fn = getattr(tfb._lib(), entry)
    want = _prototype(entry, ret)
    assert len(fn.argtypes) == len(want)
    for i, (got, kind) in enumerate(zip(fn.argtypes, want)):
        assert got is kind, f"{entry} argument {i}: {got.__name__} for {kind.__name__}"
    assert fn.restype is restype


@pytest.mark.parametrize("D", [12, 130, 4])
def test_wrapper_refuses_d_not_a_multiple_of_8(D):
    g = torch.zeros((1, 10, D), dtype=BF16)
    nn = torch.zeros((1, 3, 4), dtype=torch.int32)
    before = tfb.LAUNCHES
    with pytest.raises(ValueError, match="multiple of 8"):
        tfb.builder_core_cuda(g, torch.zeros((1, 3, D), dtype=BF16), nn)
    assert tfb.LAUNCHES == before


def test_wrapper_refuses_cpu_tensors():
    g, h, nn = _inputs(1)
    before = tfb.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tfb.builder_core_cuda(torch.from_numpy(g).to(BF16), torch.from_numpy(h).to(BF16),
                              torch.from_numpy(nn))
    assert tfb.LAUNCHES == before
