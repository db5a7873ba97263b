"""Exact softmax attention for the ACT encoder, forward and backward (port of
``pointcloudmatters_tpu/ops/oneshot_attention.py:52-278``).

Layout ``(B, H, L, dh)``, f32 or bf16. q is scaled by ``scale`` before the
product (the TPU path pre-scales q), keys at column ``l_actual`` and beyond
are masked, and the output is ``(e_drop @ v) * (1 / sum(e))`` with
``e = exp(s - max(s))``, as in the TPU kernel: dropout acts on the weights
after the (undropped) denominator is taken.

In bf16 the arithmetic is f32 (scores, row statistics, every product sum)
and rounds to bf16 where the TPU kernel rounds
(``oneshot_attention.py:91, 131, 143, 209, 273``): the pre-scaled q
(``q * bf16(scale)``), ``e_drop`` before ``e @ v``, ``p_drop`` before dV,
``ds`` before dQ and dK, dQ before its ``* bf16(scale)``, and every output.
One difference is kept on purpose: the backward's row term
``D = rowsum(dO * O)`` reads the bf16 output O, where the TPU kernel sums
the unrounded ``p * dP`` (equal in exact arithmetic, within a bf16 ulp of
O apart here).

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
behind the C entries ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``,
which raise on anything they do not take: f32 on the TF32 tensor cores in
3xTF32, exact f32 (``csrc/attention_fwd.cuh``, ``csrc/attention_bwd.cu`` on
``csrc/f32_mma.cuh``), bf16 on the bf16 tensor cores
(``csrc/attention_mma.cuh``; design notes in the sources).
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
    "rounded_scalar",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "BF16_LAUNCHES",
    "BF16_BWD_LAUNCHES",
]

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types

# launches of the forward and backward kernels in this process, f32 and bf16
# instances apart; a caller may reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0

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


def rounded_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a host float. A tensor op with it
    then computes as with a 0-d tensor of that type (one rounding of the
    f32 result), without a host-to-device copy, which would wait for the
    card."""
    return float(torch.tensor(value, dtype=dtype))


def _pre_scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's type, rounded to q's type
    (the TPU path's ``q * jnp.asarray(scale, q.dtype)``)."""
    return q * rounded_scalar(scale, q.dtype)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to ``dtype`` and back (identity for f32)."""
    return x.to(dtype).to(torch.float32)


def _scores(q_pre, k, l_actual):
    """f32 scores of the pre-scaled q against k, keys past l_actual masked."""
    s = torch.matmul(q_pre.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    col = torch.arange(k.shape[2], device=q_pre.device)
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
    (B, H, Lk, dh) -> (B, H, Lq, dh) in q's type; with ``with_stats`` also
    each row's max and 1 / denominator, (B, H, Lq) f32 each."""
    _check_rate(rate)
    H, Lq, Lk = q.shape[1], q.shape[2], k.shape[2]
    dt = q.dtype
    l_actual = Lk if l_actual is None else l_actual
    s = _scores(_pre_scaled(q, scale), k, l_actual)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = keep_mask(seed, rate, H, Lq, Lk, device=q.device)
        e = torch.where(keep, e * (1.0 / (1.0 - rate)), 0.0)
    out = (torch.matmul(_rounded(e, dt), v.to(torch.float32)) * inv).to(dt)
    if with_stats:
        return out, m[..., 0], inv[..., 0]
    return out


def oneshot_attention_plain_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, row_max: torch.Tensor, row_inv: torch.Tensor,
    scale: float, l_actual: Optional[int] = None, rate: float = 0.0,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dq, dk, dv) in q's
    type.

    ``p = exp(s - row_max) * row_inv``, ``p_drop = keep ? p / (1 - rate) : 0``,
    ``D = rowsum(dout * out)``, ``ds = p * (keep ? dP / (1 - rate) : 0 - D)``;
    ``dv = p_drop^T dout``, ``dk = ds^T (q * scale)``, ``dq = ds k * scale``
    (``csrc/attention_bwd.cu`` derives it). In bf16, ``p_drop`` and ``ds``
    are rounded before their products and dQ before its scale, as in the
    TPU kernel."""
    _check_rate(rate)
    H, Lq, Lk = q.shape[1], q.shape[2], k.shape[2]
    dt = q.dtype
    f32 = torch.float32
    l_actual = Lk if l_actual is None else l_actual
    q_pre = _pre_scaled(q, scale)
    s = _scores(q_pre, k, l_actual)
    p = torch.exp(s - row_max[..., None]) * row_inv[..., None]
    do = dout.to(f32)
    dp = torch.matmul(do, v.to(f32).transpose(-1, -2))
    delta = (do * out.to(f32)).sum(dim=-1, keepdim=True)
    if rate > 0.0:
        inv_keep = 1.0 / (1.0 - rate)
        keep = keep_mask(seed, rate, H, Lq, Lk, device=q.device)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    else:
        p_drop = p
    ds = _rounded(p * (dp - delta), dt)
    dv = torch.matmul(_rounded(p_drop, dt).transpose(-1, -2), do)
    dk = torch.matmul(ds.transpose(-1, -2), q_pre.to(f32))
    dq = _pre_scaled(torch.matmul(ds, k.to(f32)).to(dt), scale)
    return dq, dk.to(dt), dv.to(dt)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    if lib.pcm_attention_fwd.argtypes is None:
        lib.pcm_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.pcm_attention_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    if lib.pcm_attention_bwd.argtypes is None:
        lib.pcm_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.pcm_attention_bwd.restype = ctypes.c_int
    return lib


def _check_qkv(q, k, v, l_actual, rate):
    """Shape, device and type checks shared by both kernels -> l_actual."""
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev:
        raise ValueError(f"attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device} and {v.device}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"attention kernel takes f32 or bf16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype} and {v.dtype}")
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


def _heads_view(B, L, H, dh, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, L, dh) view of a new (B, L, H, dh) buffer of ``like``'s type
    and device: merging the heads afterwards copies nothing."""
    return torch.empty((B, L, H, dh), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


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
    """The forward kernel: f32 or bf16 (B, H, L, dh) tensors of one type on
    one CUDA device whose last axis is contiguous (any other strides are
    read in place), dh 64 or 128. Returns a (B, H, Lq, dh) view of a
    (B, Lq, H, dh) buffer of the inputs' type, and with ``with_stats`` the
    (B, H, Lq) f32 row max and 1 / denominator."""
    global LAUNCHES, BF16_LAUNCHES
    l_actual = _check_qkv(q, k, v, l_actual, rate)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    dev = q.device
    out = _heads_view(B, Lq, H, dh, q)
    stats = [torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
             for _ in range(2 if with_stats else 0)]
    if Lq > 0:
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        stat_ptrs = [t.data_ptr() for t in stats] if with_stats else [None, None]
        err = _fwd_lib().pcm_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *stat_ptrs,
            *strides, B, H, Lq, Lk, dh, l_actual, rounded_scalar(scale, q.dtype),
            *_dropout_args(rate, seed), int(q.dtype == torch.bfloat16), dev.index,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "attention_fwd")
        if q.dtype == torch.bfloat16:
            BF16_LAUNCHES += 1
        else:
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
    (B, L, H, dh) buffer of q's type. Same constraints as the forward;
    ``out`` and ``dout`` are of q's type with a contiguous last axis,
    ``row_max``/``row_inv`` are contiguous (B, H, Lq) f32."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    l_actual = _check_qkv(q, k, v, l_actual, rate)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    dev = q.device
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.device != dev or t.dtype != q.dtype \
                or t.stride(-1) != 1:
            raise ValueError(f"attention backward: {name} must be {q.dtype} "
                             f"{tuple(q.shape)} on {dev} with a contiguous last "
                             f"axis, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("row_max", row_max), ("row_inv", row_inv)):
        if t.shape != (B, H, Lq) or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"attention backward: {name} must be contiguous "
                             f"f32 {(B, H, Lq)} on {dev}")
    dq, dk, dv = (_heads_view(B, Lq, H, dh, q), _heads_view(B, Lk, H, dh, q),
                  _heads_view(B, Lk, H, dh, q))
    if Lq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]])
    err = _bwd_lib().pcm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        row_max.data_ptr(), row_inv.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        B, H, Lq, Lk, dh, l_actual, rounded_scalar(scale, q.dtype),
        *_dropout_args(rate, seed), int(q.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "attention_bwd")
    if q.dtype == torch.bfloat16:
        BF16_BWD_LAUNCHES += 1
    else:
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
