"""Exact softmax attention for the ACT encoder, forward and backward (port of
``pointcloudmatters_tpu/ops/oneshot_attention.py:52-278``).

Layout ``(B, H, L, dh)``, f32. q is scaled by ``scale`` before the product
(the TPU path pre-scales q), keys at column ``l_actual`` and beyond are
masked, and the output is ``(e_drop @ v) * (1 / sum(e))`` with
``e = exp(s - max(s))``, as in the TPU kernel: dropout acts on the weights
after the (undropped) denominator is taken.

Dropout keeps the TPU kernel's structure and threshold (``_keep_mask``,
``oneshot_attention.py:18-26, 52-65``): one mask per head, shared across the
batch; keep iff ``bits >= min(int(rate * 2**32), 2**32 - 1)``; survivors
scaled by ``1 / (1 - rate)``. The bits are Philox4x32-10 and a pure
function of ``(seed, head, query row, key column)``: key ``(seed, h)``,
counter ``(j // 4, i, 0, 0)``, output word ``j % 4`` (see ``csrc/philox.cuh``).
The seed is a host integer, so drawing it never waits for the device.

:func:`oneshot_attention` is an autograd function. A CPU tensor runs the
plain versions (:func:`oneshot_attention_plain`,
:func:`oneshot_attention_plain_bwd`); a CUDA tensor the hand-written kernels
``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` (design notes in
their sources), which raise on anything they do not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = [
    "oneshot_attention",
    "oneshot_attention_plain",
    "oneshot_attention_plain_bwd",
    "oneshot_attention_cuda",
    "oneshot_attention_bwd_cuda",
    "keep_mask",
    "philox4x32_10",
    "LAUNCHES",
    "BWD_LAUNCHES",
]

NEG_INF = -1e30

# launches of the forward and backward kernels in this process; a caller may
# reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``m * x`` for a uint32 constant ``m`` and a
    tensor of uint32 values held in int64. The product is split at 16 bits of
    ``m`` so that no intermediate reaches 2**63."""
    a = x * (m >> 16)      # < 2**48
    b = x * (m & 0xFFFF)   # < 2**48
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & _MASK32
    return hi, lo


def philox4x32_10(counter, key) -> list[torch.Tensor]:
    """Philox4x32-10 of Random123 in int64 torch ops: ``counter`` four and
    ``key`` two broadcastable int64 tensors (or ints) of uint32 values ->
    four int64 tensors of uint32 output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return [c0, c1, c2, c3]


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def keep_mask(seed: int, rate: float, heads: int, rows: int, cols: int,
              row0: int = 0, device=None) -> torch.Tensor:
    """The dropout keep mask, (heads, rows, cols) bool, of query rows
    ``row0 .. row0 + rows`` and key columns ``0 .. cols``; the same bits the
    kernels draw (one Philox call a group of four columns)."""
    groups = -(-cols // 4)
    h = torch.arange(heads, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[None, :, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    key0 = torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=device)
    words = philox4x32_10((g, i, zero, zero), (key0, h))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(heads, rows, groups * 4)[..., :cols]
    return bits >= _threshold(rate)


def _scores(q, k, scale, l_actual):
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    col = torch.arange(k.shape[2], device=q.device)
    return torch.where(col < l_actual, s, NEG_INF)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got {rate}")


def oneshot_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    l_actual: Optional[int] = None, rate: float = 0.0, seed: int = 0,
    with_stats: bool = False,
):
    """Plain PyTorch version of the forward kernel: (B, H, Lq, dh) x
    (B, H, Lk, dh) -> (B, H, Lq, dh); with ``with_stats`` also each row's
    max and 1 / denominator, (B, H, Lq) each."""
    _check_rate(rate)
    H, Lq, Lk = q.shape[1], q.shape[2], k.shape[2]
    l_actual = Lk if l_actual is None else l_actual
    s = _scores(q, k, scale, l_actual)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = keep_mask(seed, rate, H, Lq, Lk, device=q.device)
        e = torch.where(keep, e * (1.0 / (1.0 - rate)), 0.0)
    out = torch.matmul(e, v) * inv
    if with_stats:
        return out, m[..., 0], inv[..., 0]
    return out


def oneshot_attention_plain_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, row_max: torch.Tensor, row_inv: torch.Tensor,
    scale: float, l_actual: Optional[int] = None, rate: float = 0.0,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dq, dk, dv).

    ``p = exp(s - row_max) * row_inv``, ``p_drop = keep ? p / (1 - rate) : 0``,
    ``D = rowsum(dout * out)``, ``ds = p * (keep ? dP / (1 - rate) : 0 - D)``;
    ``dv = p_drop^T dout``, ``dk = ds^T (q * scale)``, ``dq = ds k * scale``
    (``csrc/attention_bwd.cu`` derives it)."""
    _check_rate(rate)
    H, Lq, Lk = q.shape[1], q.shape[2], k.shape[2]
    l_actual = Lk if l_actual is None else l_actual
    q_pre = q * scale
    s = _scores(q, k, scale, l_actual)
    p = torch.exp(s - row_max[..., None]) * row_inv[..., None]
    dp = torch.matmul(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(dim=-1, keepdim=True)
    if rate > 0.0:
        inv_keep = 1.0 / (1.0 - rate)
        keep = keep_mask(seed, rate, H, Lq, Lk, device=q.device)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    else:
        p_drop = p
    ds = p * (dp - delta)
    dv = torch.matmul(p_drop.transpose(-1, -2), dout)
    dk = torch.matmul(ds.transpose(-1, -2), q_pre)
    dq = torch.matmul(ds, k) * scale
    return dq, dk, dv


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    if lib.pcm_attention_fwd.argtypes is None:
        lib.pcm_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.pcm_attention_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    if lib.pcm_attention_bwd.argtypes is None:
        lib.pcm_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.pcm_attention_bwd.restype = ctypes.c_int
    return lib


def _check_qkv(q, k, v, l_actual, rate):
    """Shape, device and type checks shared by both kernels -> l_actual."""
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev:
        raise ValueError(f"attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device} and {v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError(f"attention kernel takes f32, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"attention kernel shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != dh or dh not in (64, 128):
        raise ValueError(f"attention kernel takes matching (B, H) and dh in "
                         f"(64, 128), got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous last axis")
    l_actual = Lk if l_actual is None else int(l_actual)
    if not 1 <= l_actual <= Lk or B * H > 65535:
        raise ValueError(f"attention kernel takes 1 <= l_actual <= Lk and "
                         f"B*H <= 65535, got l_actual={l_actual}, Lk={Lk}, "
                         f"B*H={B * H}")
    _check_rate(rate)
    return l_actual


def _heads_view(B, L, H, dh, dev) -> torch.Tensor:
    """A (B, H, L, dh) view of a new (B, L, H, dh) f32 buffer: merging the
    heads afterwards copies nothing."""
    return torch.empty((B, L, H, dh), dtype=torch.float32, device=dev).transpose(1, 2)


def _dropout_args(rate: float, seed: int) -> tuple:
    """(threshold, inv_keep, seed, dropout) as the kernels take them."""
    if rate == 0.0:
        return 0, 1.0, 0, 0
    return _threshold(rate), 1.0 / (1.0 - rate), int(seed) & _MASK32, 1


def oneshot_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    l_actual: Optional[int] = None, rate: float = 0.0, seed: int = 0,
    with_stats: bool = False,
):
    """The forward kernel: f32 (B, H, L, dh) tensors on one CUDA device whose
    last axis is contiguous (any other strides are read in place), dh 64 or
    128. Returns a (B, H, Lq, dh) view of a (B, Lq, H, dh) buffer, and with
    ``with_stats`` the (B, H, Lq) row max and 1 / denominator."""
    global LAUNCHES
    l_actual = _check_qkv(q, k, v, l_actual, rate)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    dev = q.device
    out = _heads_view(B, Lq, H, dh, dev)
    stats = [torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
             for _ in range(2 if with_stats else 0)]
    if Lq > 0:
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        stat_ptrs = [t.data_ptr() for t in stats] if with_stats else [None, None]
        err = _fwd_lib().pcm_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *stat_ptrs,
            *strides, B, H, Lq, Lk, dh, l_actual, float(scale),
            *_dropout_args(rate, seed), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "attention_fwd")
        LAUNCHES += 1
    return (out, *stats) if with_stats else out


def oneshot_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, row_max: torch.Tensor, row_inv: torch.Tensor,
    scale: float, l_actual: Optional[int] = None, rate: float = 0.0,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: the forward's inputs, its output ``out`` and
    statistics, and ``dout`` -> (dq, dk, dv), each a (B, H, L, dh) view of a
    (B, L, H, dh) buffer. Same constraints as the forward; ``out`` and
    ``dout`` need a contiguous last axis, ``row_max``/``row_inv`` are
    contiguous (B, H, Lq) f32."""
    global BWD_LAUNCHES
    l_actual = _check_qkv(q, k, v, l_actual, rate)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    dev = q.device
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.device != dev or t.dtype != torch.float32 \
                or t.stride(-1) != 1:
            raise ValueError(f"attention backward: {name} must be f32 "
                             f"{tuple(q.shape)} on {dev} with a contiguous last "
                             f"axis, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("row_max", row_max), ("row_inv", row_inv)):
        if t.shape != (B, H, Lq) or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"attention backward: {name} must be contiguous "
                             f"f32 {(B, H, Lq)} on {dev}")
    dq, dk, dv = (_heads_view(B, Lq, H, dh, dev), _heads_view(B, Lk, H, dh, dev),
                  _heads_view(B, Lk, H, dh, dev))
    if Lq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    err = _bwd_lib().pcm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_inv.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        B, H, Lq, Lk, dh, l_actual, float(scale), *_dropout_args(rate, seed),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _OneshotAttention(torch.autograd.Function):
    """Forward by kernel 3, backward by kernel 4 (or their plain versions for
    CPU tensors); saves q, k, v, the output and the row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rate, seed, l_actual):
        stats = any(ctx.needs_input_grad[:3])
        fwd = oneshot_attention_plain if q.device.type == "cpu" else oneshot_attention_cuda
        res = fwd(q, k, v, scale, l_actual, rate, seed, with_stats=stats)
        if not stats:
            return res
        out, row_max, row_inv = res
        ctx.save_for_backward(q, k, v, out, row_max, row_inv)
        ctx.args = (scale, l_actual, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, row_max, row_inv = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        bwd = (oneshot_attention_plain_bwd if q.device.type == "cpu"
               else oneshot_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, out, dout, row_max, row_inv, *ctx.args)
        return dq, dk, dv, None, None, None, None


def oneshot_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    rate: float = 0.0, l_actual: Optional[int] = None, seed: int = 0,
) -> torch.Tensor:
    """Exact softmax attention, (B, H, L, dh), differentiable in q, k and v;
    see the module docstring.

    Args:
        q: (B, H, Lq, dh); k/v: (B, H, Lk, dh).
        scale: logit scale (1/sqrt(dh)).
        rate: attention-weight dropout rate in [0, 1).
        l_actual: keys at this column and beyond are masked (default Lk).
        seed: the dropout mask's seed, a host integer (its low 32 bits).
    """
    return _OneshotAttention.apply(q, k, v, scale, rate, int(seed), l_actual)
