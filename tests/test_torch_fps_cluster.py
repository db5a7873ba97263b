"""The FPS kernel's cluster decomposition (``csrc/fps.cu``) and its launch
rules (``ops/fps.py``), on the CPU.

The kernel spreads a cloud over a cluster of C CTAs: CTA r owns the
contiguous slice [r S, (r + 1) S), S = ceil(N / C), its thread t the slice
points t, t + T, t + 2T, ...; a round takes each thread's argmax in slot
order (a strict >), then the best (value, index) of each warp, of each CTA
and of the C CTA records: the largest value, the smallest index among
equal ones. A numpy emulation of that decomposition is held index for
index against the port's plain version (``farthest_point_sampling_padded_plain``),
JAX's XLA FPS (the plain reference of its Pallas kernel) and the Pallas
kernel itself in interpret mode, for C in {1, 2, 4, 8, 16}: exact ties,
invalid points, rows with fewer valid points than ``npoints``, N not
divisible by C, and slices of more points than a CTA holds (above
196,608 points a cloud the kernel streams the rest of each slice, in the
same order a thread). The kernel itself runs on the card only
(``chip_smoke.py`` phase 3 holds it index-exact against the plain version
there).

The cluster-size and thread chooser is checked against its rules on a model of an
H100 (132 SMs in GPCs of 18, 16 and 14), and the C entry points against
the wrapper's ctypes argtypes and constants.
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

from pointcloudmatters_tpu.ops import pallas_fps as jfps
from pointcloudmatters_tpu.ops import pointops as jops
from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import fps as tfps
from pointcloudmatters_tpu_torch.ops import pointops as tpo

SOURCE = os.path.join(_build.CSRC, "fps.cu")
NO_INDEX = 0x7FFFFFFF
MAX_POINTS = NO_INDEX - 1  # pcm_fps_max_points(): an index stays below NO_INDEX


def _best(values: np.ndarray, index: np.ndarray, axis: int):
    """The largest value along ``axis`` and the smallest index among the
    positions that hold it (``take_better``)."""
    top = values.max(axis=axis, keepdims=True)
    idx = np.where(values == top, index, np.iinfo(np.int64).max).min(axis=axis)
    return np.squeeze(top, axis), idx


def emulate_cluster_fps(xyz: np.ndarray, mask: np.ndarray, npoints: int, C: int,
                        T: int) -> np.ndarray:
    """The kernel's rounds in numpy f32, with its slices, threads, warps and
    CTA records."""
    B, N, _ = xyz.shape
    x0, x1, x2 = (xyz[..., i].astype(np.float32) for i in range(3))
    sq = (x0 * x0 + x1 * x1) + x2 * x2
    S = -(-N // C)
    ppt = -(-S // T)
    out = np.zeros((B, npoints), np.int32)
    for b in range(B):
        dist = np.where(mask[b], np.float32(1e10), np.float32(-1.0)).astype(np.float32)
        last = 0
        for it in range(1, npoints):
            dot = (x0[b] * x0[b, last] + x1[b] * x1[b, last]) + x2[b] * x2[b, last]
            d = (sq[b] + sq[b, last]) - np.float32(2.0) * dot
            dist = np.where(mask[b], np.minimum(dist, d), dist).astype(np.float32)
            rec_v, rec_i = [], []
            for r in range(C):
                lo = r * S
                own = dist[lo:min(N, lo + S)]
                # slot i of thread t is slice point t + i T; -inf past the slice
                slots = np.full(ppt * T, -np.inf, np.float32)
                slots[:own.size] = own
                slots = slots.reshape(ppt, T)
                first = slots.argmax(axis=0)  # the first maximum: a strict >
                tv = slots[first, np.arange(T)]
                ti = np.where(tv > -np.inf, lo + np.arange(T) + first * T, NO_INDEX)
                wv, wi = _best(tv.reshape(T // 32, 32), ti.reshape(T // 32, 32), 1)
                cv, ci = _best(wv, wi, 0)
                rec_v.append(cv)
                rec_i.append(ci)
            _, last = _best(np.array(rec_v), np.array(rec_i), 0)
            out[b, it] = last
    return out


def _case(kind: str, N: int, seed: int):
    """(xyz, mask) of 3 rows: exact ties on a coarse grid with duplicated
    points, holes in the mask, or a row with fewer valid points than
    npoints."""
    rng = np.random.RandomState(seed)
    B = 3
    if kind == "ties":
        xyz = (rng.randint(0, 4, (B, N, 3)) * 0.25).astype(np.float32)
        xyz[:, N // 2:] = xyz[:, : N - N // 2]
        mask = np.ones((B, N), bool)
    else:
        xyz = (rng.rand(B, N, 3) * 0.4 - 0.2).astype(np.float32)
        mask = rng.rand(B, N) < 0.7 if kind == "holes" else np.ones((B, N), bool)
    if kind == "few":
        mask[1] = np.arange(N) < 10
        mask[2] = (np.arange(N) % 97) == 5  # valid points scattered, index 0 invalid
    return xyz, mask


@functools.lru_cache(maxsize=None)
def _references(kind: str, N: int, npoints: int, seed: int):
    xyz, mask = _case(kind, N, seed)
    plain = tpo.farthest_point_sampling_padded(
        torch.from_numpy(xyz), torch.from_numpy(mask), npoints).numpy()
    xla = np.asarray(jops._farthest_point_sampling_padded_xla(
        jnp.asarray(xyz), jnp.asarray(mask), npoints))
    return xyz, mask, plain, xla


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind,N", [("ties", 2048), ("holes", 1001), ("few", 777),
                                    ("ties", 515)])
def test_cluster_decomposition_is_index_exact(kind, N, C):
    npoints = 40
    xyz, mask, plain, xla = _references(kind, N, npoints, N + C % 3)
    np.testing.assert_array_equal(plain, xla)
    for share in (1, 4, 32):  # 2 to 12 points a thread
        T = tfps.cta_threads(tfps.cluster_slice(N, C), share)
        got = emulate_cluster_fps(xyz, mask, npoints, C, T)
        np.testing.assert_array_equal(got, plain, err_msg=f"C={C} T={T}")
    if kind == "few":  # the row of 10 valid points repeats indices
        assert len(set(plain[1].tolist())) <= 10


@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("kind,N", [("ties", 8192), ("holes", 7001)])
def test_streamed_slices_are_index_exact(kind, N, C):
    """A streamed slice: with T = 1024 a CTA holds MAX_POINTS_PER_THREAD
    points a thread, t + i T, and streams slice points t + (12 + k) T after
    them, so a thread's points stay in index order past its held slots.
    The emulation at T = 32 takes 14 to 256 points a thread, beyond its 12
    slots, in that order."""
    npoints = 40
    xyz, mask, plain, xla = _references(kind, N, npoints, N + C % 3)
    np.testing.assert_array_equal(plain, xla)
    T = 32
    assert -(-tfps.cluster_slice(N, C) // T) > tfps.MAX_POINTS_PER_THREAD
    got = emulate_cluster_fps(xyz, mask, npoints, C, T)
    np.testing.assert_array_equal(got, plain, err_msg=f"C={C} T={T}")


def test_plain_matches_the_pallas_kernel_in_interpret_mode(monkeypatch):
    """The port's plain FPS against JAX's Pallas kernel itself, run by the
    Pallas interpreter on the CPU, on ties and holes."""
    real = jfps.pl
    interp = types.SimpleNamespace(
        **{k: getattr(real, k) for k in dir(real) if not k.startswith("_")})
    interp.pallas_call = functools.partial(real.pallas_call, interpret=True)
    monkeypatch.setattr(jfps, "pl", interp)
    for kind, N in (("ties", 256), ("holes", 300)):
        xyz, mask = _case(kind, N, 3)
        want = np.asarray(jfps.farthest_point_sampling_padded_pallas(
            jnp.asarray(xyz), jnp.asarray(mask), 24))
        got = tpo.farthest_point_sampling_padded(
            torch.from_numpy(xyz), torch.from_numpy(mask), 24).numpy()
        np.testing.assert_array_equal(got, want)


# ---- the launch rules -------------------------------------------------------------

H100_GPCS = (18, 18, 18, 18, 16, 16, 14, 14)  # 132 SMs


def h100_active_clusters(C: int, T: int) -> int:
    """Clusters of C CTAs of T threads an H100 holds at once, in a model:
    a cluster lies in one GPC, and an SM takes as many CTAs as its 65,536
    registers hold at the kernel's ~64 a thread (at most 32)."""
    per_sm = min(32, 1024 // T)
    return sum(g * per_sm // C for g in H100_GPCS)


def _least(N: int) -> int:
    C = 1
    while C * tfps.MAX_SLICE < N and C < tfps.MAX_CLUSTER:
        C *= 2
    return C


def _first_fit(B, N, C):
    """The threads for the least CTAs-a-SM count from ceil(B C / 132) that
    let B clusters of C fit, or None."""
    S = tfps.cluster_slice(N, C)
    for share in range(-(-B * C // 132), 33):
        T = tfps.cta_threads(S, share)
        if h100_active_clusters(C, T) >= B:
            return T
    return None


@pytest.mark.parametrize("B", [1, 4, 32, 64])
@pytest.mark.parametrize("N", [1, 100, 10240, 20480, 40960, 40961, tfps.MAX_RESIDENT,
                               tfps.MAX_RESIDENT + 1, 1 << 20])
def test_cluster_chooser_meets_its_rules(B, N):
    C, T = tfps.choose_cluster(B, N, 132, h100_active_clusters)
    least = _least(N)
    assert C in (1, 2, 4, 8, 16) and least <= C <= tfps.MAX_CLUSTER
    S = tfps.cluster_slice(N, C)
    assert -(-min(S, tfps.MAX_SLICE) // T) <= tfps.MAX_POINTS_PER_THREAD
    if S > tfps.MAX_SLICE:  # streamed: the largest cluster, 12 points held a thread
        assert N > tfps.MAX_RESIDENT and (C, T) == (tfps.MAX_CLUSTER, tfps.MAX_THREADS)
    assert T % 32 == 0 and 32 <= T <= 1024
    if C > least:
        assert T == _first_fit(B, N, C) and h100_active_clusters(C, T) >= B
    else:
        assert T == (_first_fit(B, N, C) or tfps.cta_threads(S, -(-B * C // 132)))
        assert h100_active_clusters(C, T) >= 1
    for larger in (2 * C, 4 * C, 8 * C, 16 * C):  # no larger size lets B clusters fit
        if larger <= tfps.MAX_CLUSTER:
            assert _first_fit(B, N, larger) is None


def test_cta_threads_share_the_warps_of_an_sm():
    for S in (1, 100, 640, 1280, 2560, 5120, 10240, tfps.MAX_SLICE):
        for share in (1, 2, 4, 8, 32):
            T = tfps.cta_threads(S, share)
            assert T % 32 == 0 and 32 <= T <= 1024
            assert -(-S // T) <= tfps.MAX_POINTS_PER_THREAD  # the kernel takes it
            # WARPS_PER_SM between the CTAs of an SM, 2 points a thread at least,
            # unless the slice needs more threads
            assert T <= max(32 * max(1, tfps.WARPS_PER_SM // share), 32 * -(-S // 64),
                            32 * -(-S // (32 * tfps.MAX_POINTS_PER_THREAD)))
    assert tfps.cta_threads(640, 1) == 320   # 10,240 points over 16 CTAs, one an SM
    assert tfps.cta_threads(640, 4) == 128   # the same, four CTAs an SM
    assert tfps.cta_threads(2560, 1) == 512  # 40,960 points: 16 warps


def test_cluster_chooser_cases():
    choose = functools.partial(tfps.choose_cluster, sm_count=132,
                               active_clusters=h100_active_clusters)
    assert choose(1, 10240) == (16, 320)   # the rollout shape: 16 SMs, 2 points a thread
    assert choose(4, 10240) == (16, 320)
    assert choose(32, 10240) == (16, 128)  # 4 CTAs an SM, 4 warps each
    assert choose(4, 20480) == (16, 512)
    assert choose(64, 40960)[0] == 4       # the least size: 40,960 / 12,288 -> 4
    assert choose(4, 40961) == (16, 512)   # one point above 40,960
    # what a cluster holds: 16 CTAs of 12,288 points, 1024 threads each
    assert choose(1, 196608) == choose(64, 196608) == (16, 1024)
    assert choose(200, 10240)[0] == 1      # 200 clusters fit no larger size
    with pytest.raises(ValueError):
        tfps.choose_cluster(1, 10240, 132, lambda C, T: 0)
    # above it the same cluster streams the rest of each slice
    assert choose(1, 300000) == choose(64, 1 << 20) == (16, 1024)


def test_slice_limits_match_the_source():
    with open(SOURCE) as f:
        text = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kMaxThreads"]) * int(consts["kMaxPPT"]) == tfps.MAX_SLICE
    assert int(consts["kMaxPPT"]) == tfps.MAX_POINTS_PER_THREAD
    assert int(consts["kMaxCluster"]) == tfps.MAX_CLUSTER
    assert int(consts["kMaxThreads"]) == tfps.MAX_THREADS
    # the largest slice as float4, two parities of a 24-byte record of each
    # of 16 CTAs and the static 528 bytes fit the 227 KiB of a block
    assert tfps.MAX_SLICE * 16 + 2 * 16 * 24 + 528 <= 232448
    # what a cluster holds: the largest size, each CTA the largest slice
    assert re.search(r"constexpr int kMaxResident = kMaxCluster \* kMaxSlice;", text)
    assert tfps.MAX_RESIDENT == tfps.MAX_CLUSTER * tfps.MAX_SLICE == 196608
    # a cloud: any N whose indices stay below the "no index"
    assert re.search(r"constexpr uint32_t kNoIndex = 0x7fffffffu;", text)
    assert re.search(r"constexpr int kMaxN = \(int\)kNoIndex - 1;", text)
    assert "int pcm_fps_max_points() { return kMaxN; }" in text


_CTYPE_OF = {"int": ctypes.c_int}


def _prototype(name: str) -> list:
    """ctypes kinds of the parameters of ``int name(...)`` in fps.cu."""
    with open(SOURCE) as f:
        text = f.read()
    match = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", text)
    assert match, f"no prototype of {name}"
    return [ctypes.c_void_p if "*" in p else _CTYPE_OF[" ".join(p.split()[:-1])]
            for p in match.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("limit", [40960, MAX_POINTS])  # 40,960 points, and the kernel's limit
@pytest.mark.parametrize("entry", ["pcm_fps", "pcm_fps_max_active_clusters"])
def test_wrapper_argtypes_match_c_prototypes(monkeypatch, entry, limit):
    values = {"pcm_fps_max_slice": tfps.MAX_SLICE,
              "pcm_fps_max_points_per_thread": tfps.MAX_POINTS_PER_THREAD,
              "pcm_fps_max_points": limit}

    class FakeLib:
        def __getattr__(self, name):
            value = values.get(name, 0)
            fn = lambda *args: value  # noqa: E731
            fn.argtypes = fn.restype = None
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda name: FakeLib())
    fn = getattr(tfps._lib(), entry)
    want = _prototype(entry)
    assert len(fn.argtypes) == len(want)
    for i, (got, kind) in enumerate(zip(fn.argtypes, want)):
        assert got is kind, f"{entry} argument {i}: {got.__name__} for {kind.__name__}"
    assert fn.restype is ctypes.c_int


# ---- clouds above what a cluster holds ------------------------------------------


class _FpsLib:
    """The FPS library's constants without a build (no nvcc on the CPU)."""

    def __init__(self):
        self.values = {"pcm_fps_max_slice": tfps.MAX_SLICE,
                       "pcm_fps_max_points_per_thread": tfps.MAX_POINTS_PER_THREAD,
                       "pcm_fps_max_points": MAX_POINTS}

    def __getattr__(self, name):
        value = self.values.get(name, 0)
        fn = lambda *args: value  # noqa: E731
        fn.argtypes = fn.restype = None
        setattr(self, name, fn)
        return fn


def test_kernel_takes_every_index(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: _FpsLib())
    assert tfps.max_points() == MAX_POINTS == NO_INDEX - 1
    assert tfps.max_points() > 1000 * tfps.MAX_RESIDENT


def test_cpu_fps_needs_no_library(monkeypatch):
    def no_build(name):
        raise AssertionError("FPS on the CPU loaded a library")

    monkeypatch.setattr(_build, "load", no_build)
    xyz, mask, plain, _ = _references("holes", 1001, 40, 1001)
    got = tpo.farthest_point_sampling_padded(torch.from_numpy(xyz), torch.from_numpy(mask), 40)
    np.testing.assert_array_equal(got.numpy(), plain)


def test_plain_above_what_a_cluster_holds_matches_jax():
    """One point above what a cluster holds (where the kernel starts to
    stream), the plain version the card holds the kernel against is index
    for index JAX's XLA FPS, and no launch is counted on the CPU."""
    N = tfps.MAX_RESIDENT + 1
    rng = np.random.RandomState(4)
    xyz = (rng.rand(2, N, 3) * 0.4 - 0.2).astype(np.float32)
    mask = rng.rand(2, N) < 0.9
    mask[1, 7:] = False  # fewer valid points than samples: indices repeat
    before = tfps.LAUNCHES
    got = tpo.farthest_point_sampling_padded(
        torch.from_numpy(xyz), torch.from_numpy(mask), 12).numpy()
    want = np.asarray(jops._farthest_point_sampling_padded_xla(
        jnp.asarray(xyz), jnp.asarray(mask), 12))
    np.testing.assert_array_equal(got, want)
    assert tfps.LAUNCHES == before
