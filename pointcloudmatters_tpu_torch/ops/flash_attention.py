"""Flash attention with in-kernel broadcast dropout, forward and backward
(port of ``pointcloudmatters_tpu/ops/flash_attention.py``: the function of
its three TPU kernels, not their tiling).

Layout ``(B, H, L, dh)``, q, k and v of one type, f32 or bf16; an optional
bias ``ab`` (B, H, Lq, Lk); optional :class:`SegmentIds` (a query attends
to the keys of its own segment); ``causal``; the logit scale ``sm_scale``.
The plain versions follow the TPU kernels' arithmetic
(``flash_attention.py`` line numbers):

- scores ``s = (q k^T in f32 + ab) * sm_scale`` (:485-499): the scale goes
  on the f32 scores, q is not pre-scaled and rounded (unlike the oneshot
  path);
- masks are **added**, ``s + where(mask, 0, DEFAULT_MASK_VALUE)`` (:527),
  never substituted: in f32 a masked score rounds to the mask value itself,
  so a row whose keys are all masked weighs all its visited keys alike;
- with ``causal`` a (``block_q``, ``block_k``) tile that lies wholly above
  the diagonal is not visited at all (``below_or_on_diag``, :413-416): its
  keys do not count for the row, masked or not. That is the only effect of
  ``block_q``;
- the forward is the online softmax over ``block_k``-key blocks
  (:476-574): ``p = exp(s - m_next)`` against the running max, ``l`` sums
  the undropped p, the accumulator is rescaled and divided by ``l`` at each
  block; with ``block_k >= Lk`` the single-step variant (:647-665)
  normalises p before dropout. It returns o and the row statistics l and m
  (f32) for the backward;
- dropout acts after normalisation, so l accumulates the undropped sums
  (:557-566);
- the backward takes ``di = rowsum(o * do)`` in f32 outside its kernels
  (:319-321), recomputes ``p = exp(s - m) * (1 / l)`` from the saved
  statistics and forms ``dS = (dP * D / keep - di) * p * sm_scale``
  (:1007-1041, :1361-1388); dK/dV (kernel 10) and dQ (kernel 11), which also
  returns ``ds``, the bias gradient, when ``ab`` is given.

bf16 rounds where the TPU kernels round (:571-573, :1023-1024, :1045,
:1397-1399): ``p * D / keep`` before ``p v``, with p taken against the
running max after each ``block_k`` block (normalised first in the
single-step variant); ``p_dropped`` before dV; dS before dK and before dQ;
l, m, di and every accumulator stay f32 and each output rounds once. The
plain forward and the CUDA kernel both reproduce the block granularity, the
plain version by its loop over ``block_k`` blocks, the kernel by a row-max
pass over each block before its p (``csrc/flash_attention.cu``).

Dropout: the TPU mask is hardware random bits seeded by (seed, q tile, kv
tile) (:379-394), which nothing else reproduces. The port keeps its
structure, one mask shared across batch **and** heads, and its threshold and
scale exactly: keep iff ``bits >= min(int(rate * 2**32), 2**32 - 1)``,
survivors scaled by ``f32(1 / keep)`` with ``keep = 1 - threshold / 2**32``
(not ``1 / (1 - rate)``). The bits are Philox4x32-10 and a pure function of
(seed, query row, key column), with no batch, head or tile index: key
``(seed, 0)``, counter ``(j // 4, i, 1, 0)``, output word ``j % 4``. The
third counter word, 0 in the oneshot mask (key ``(seed, head)``), keeps the
two streams apart. :func:`flash_keep_mask` computes it for the plain
versions and the tests.

:func:`flash_attention` is an autograd function. A CPU tensor runs the
plain versions (:func:`flash_attention_plain`,
:func:`flash_attention_plain_bwd_dkv`, :func:`flash_attention_plain_bwd_dq`);
a CUDA tensor the hand-written kernels of ``csrc/flash_attention.cu``
(kernels 9, 10 and 11; at bf16, 10 and 11 are the tensor-core kernels of
``csrc/flash_mma.cuh``), which raise on anything they do not take.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops.oneshot_attention import (
    _MASK32,
    _check_rate,
    _heads_view,
    _rounded,
    _threshold,
    philox4x32_10,
)

__all__ = [
    "DEFAULT_MASK_VALUE",
    "SegmentIds",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_plain_bwd_dkv",
    "flash_attention_plain_bwd_dq",
    "flash_attention_cuda",
    "flash_attention_bwd_dkv_cuda",
    "flash_attention_bwd_dq_cuda",
    "flash_keep_mask",
    "FWD_LAUNCHES",
    "DKV_LAUNCHES",
    "DQ_LAUNCHES",
    "BF16_FWD_LAUNCHES",
    "BF16_DKV_LAUNCHES",
    "BF16_DQ_LAUNCHES",
]

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types

# launches of kernels 9 (forward), 10 (dK/dV) and 11 (dQ) in this process,
# f32 and bf16 instances apart; a caller may reset them to 0
FWD_LAUNCHES = 0
DKV_LAUNCHES = 0
DQ_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_DKV_LAUNCHES = 0
BF16_DQ_LAUNCHES = 0


class SegmentIds(NamedTuple):
    """Segment ids of the query and key rows, (B, Lq) and (B, Lk) int32: a
    query attends only to keys of its own id."""

    q: torch.Tensor
    kv: torch.Tensor


def flash_keep_mask(seed: int, rate: float, rows: int, cols: int,
                    row0: int = 0, device=None) -> torch.Tensor:
    """The dropout keep mask, (rows, cols) bool, of query rows ``row0 ..
    row0 + rows`` and key columns ``0 .. cols``, shared by every batch item
    and head; the bits the kernels draw (one Philox call a group of four
    columns)."""
    groups = -(-cols // 4)
    i = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    one = torch.ones((), dtype=torch.int64, device=device)
    key0 = torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=device)
    words = philox4x32_10((g, i, one, zero), (key0, zero))
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(rows, groups * 4)[:, :cols] >= _threshold(rate)


def _inv_keep(rate: float) -> float:
    """The survivors' scale, 1 / keep with keep = 1 - threshold / 2**32, as
    the TPU kernel takes it (``_dropout_scale_tile``)."""
    return 1.0 / (1.0 - _threshold(rate) / 4294967296.0)


def _drop_scale(seed: int, rate: float, Lq: int, Lk: int, device) -> torch.Tensor:
    """(Lq, Lk) f32: f32(1 / keep) where kept, 0 where dropped."""
    keep = flash_keep_mask(seed, rate, Lq, Lk, device=device)
    return keep.to(torch.float32) * _inv_keep(rate)


def _last_rows(Lq: int, block_q: int, device) -> torch.Tensor:
    """(Lq, 1): the last row of each row's ``block_q`` tile."""
    return ((torch.arange(Lq, device=device) // block_q + 1) * block_q - 1)[:, None]


def _visited(Lq: int, Lk: int, block_q: int, block_k: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: the pairs whose (block_q, block_k) tile lies below or
    on the diagonal (``below_or_on_diag``: its bottom-left corner's row
    exceeds its column), the tiles the causal kernels visit."""
    first_cols = torch.arange(Lk, device=device) // block_k * block_k
    return _last_rows(Lq, block_q, device) > first_cols[None, :]


def _scores(q, k, ab, segment_ids, causal, sm_scale, k0, k1) -> torch.Tensor:
    """f32 scores of keys k0..k1: ``(q k^T + ab) * sm_scale`` plus the mask
    value where a segment or the causal order masks."""
    s = torch.matmul(q.to(torch.float32), k[:, :, k0:k1].to(torch.float32).transpose(-1, -2))
    if ab is not None:
        s = s + ab[..., k0:k1].to(torch.float32)
    if sm_scale != 1.0:
        s = s * sm_scale
    mask = None
    if segment_ids is not None:
        mask = (segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, k0:k1])
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[:, None]
        col = torch.arange(k0, k1, device=q.device)[None, :]
        mask = col <= row if mask is None else mask & (col <= row)
    if mask is not None:
        s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    return s


def _check_args(q, k, v, ab, segment_ids, dropout_rate, dropout_seed,
                block_q, block_k) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    if ab is not None and tuple(ab.shape) != (B, H, Lq, Lk):
        raise ValueError(f"flash attention bias must be {(B, H, Lq, Lk)}, got "
                         f"{tuple(ab.shape)}")
    if segment_ids is not None and (tuple(segment_ids.q.shape) != (B, Lq)
                                    or tuple(segment_ids.kv.shape) != (B, Lk)):
        raise ValueError(f"flash attention segment ids must be {(B, Lq)} and "
                         f"{(B, Lk)}, got {tuple(segment_ids.q.shape)} and "
                         f"{tuple(segment_ids.kv.shape)}")
    _check_rate(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_seed is required when dropout_rate > 0")
    if block_q < 2 or block_k < 1:
        raise ValueError(f"flash attention blocks must be block_q >= 2 and "
                         f"block_k >= 1, got {block_q} and {block_k}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ab: Optional[torch.Tensor] = None, segment_ids: Optional[SegmentIds] = None,
    *, causal: bool = False, sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 9 -> (o in q's type, l, m), l and m
    (B, H, Lq) f32; the TPU kernel's arithmetic block by block (see the
    module docstring)."""
    _check_args(q, k, v, ab, segment_ids, dropout_rate, dropout_seed, block_q, block_k)
    B, H, Lq, dh = q.shape
    Lk = k.shape[2]
    dt, f32, dev = q.dtype, torch.float32, q.device
    drop = (_drop_scale(dropout_seed, dropout_rate, Lq, Lk, dev)
            if dropout_rate > 0.0 else None)
    if block_k >= Lk:  # the single-step variant: one block, p normalised first
        s = _scores(q, k, ab, segment_ids, causal, sm_scale, 0, Lk)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        if drop is not None:
            p = p * drop
        o = torch.matmul(_rounded(p, dt), v.to(f32))
        return o.to(dt), l[..., 0], m[..., 0]

    m = torch.full((B, H, Lq, 1), -float("inf"), dtype=f32, device=dev)
    l = torch.zeros((B, H, Lq, 1), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Lq, dh), dtype=f32, device=dev)
    for k0 in range(0, Lk, block_k):
        k1 = min(k0 + block_k, Lk)
        s = _scores(q, k, ab, segment_ids, causal, sm_scale, k0, k1)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        if drop is not None:
            p = p * drop[:, k0:k1]
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc_next = acc * (l_corr * inv) + torch.matmul(
            _rounded(p, dt), v[:, :, k0:k1].to(f32)) * inv
        if causal:  # rows whose tile is not visited keep their state
            run = _last_rows(Lq, block_q, dev) > k0
            m_next, l_next = torch.where(run, m_next, m), torch.where(run, l_next, l)
            acc_next = torch.where(run, acc_next, acc)
        m, l, acc = m_next, l_next, acc_next
    return acc.to(dt), l[..., 0], m[..., 0]


def _probs_and_ds(q, k, v, ab, segment_ids, l, m, do, di, causal, sm_scale,
                  dropout_rate, dropout_seed, block_q, block_k):
    """(p_dropped, ds), (B, H, Lq, Lk) f32 each, of the backward kernels:
    ``p = exp(s - m) * (1 / l)`` on visited pairs (0 elsewhere)."""
    Lq, Lk = q.shape[2], k.shape[2]
    f32 = torch.float32
    s = _scores(q, k, ab, segment_ids, causal, sm_scale, 0, Lk)
    p = torch.exp(s - m[..., None]) * (1 / l)[..., None]
    if causal:
        p = torch.where(_visited(Lq, Lk, block_q, block_k, q.device), p, 0.0)
    dp = torch.matmul(do.to(f32), v.to(f32).transpose(-1, -2))
    p_dropped = p
    if dropout_rate > 0.0:
        drop = _drop_scale(dropout_seed, dropout_rate, Lq, Lk, q.device)
        p_dropped = p * drop
        dp = dp * drop
    ds = (dp - di[..., None]) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    return p_dropped, ds


def flash_attention_plain_bwd_dkv(
    q, k, v, ab, segment_ids, l, m, do, di, *, causal: bool = False,
    sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 10 -> (dk, dv) in k's type:
    ``dv = bf16(p_dropped)^T do``, ``dk = bf16(ds)^T q`` (f32 sums)."""
    _check_args(q, k, v, ab, segment_ids, dropout_rate, dropout_seed, block_q, block_k)
    dt = q.dtype
    p_dropped, ds = _probs_and_ds(q, k, v, ab, segment_ids, l, m, do, di, causal, sm_scale,
                                  dropout_rate, dropout_seed, block_q, block_k)
    dv = torch.matmul(_rounded(p_dropped, dt).transpose(-1, -2), do.to(torch.float32))
    dk = torch.matmul(_rounded(ds, dt).transpose(-1, -2), q.to(torch.float32))
    return dk.to(dt), dv.to(dt)


def flash_attention_plain_bwd_dq(
    q, k, v, ab, segment_ids, l, m, do, di, *, causal: bool = False,
    sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel 11 -> (dq in q's type, ds in ab's
    type or None): ``dq = bf16(ds) k`` (f32 sums)."""
    _check_args(q, k, v, ab, segment_ids, dropout_rate, dropout_seed, block_q, block_k)
    _, ds = _probs_and_ds(q, k, v, ab, segment_ids, l, m, do, di, causal, sm_scale,
                          dropout_rate, dropout_seed, block_q, block_k)
    dq = torch.matmul(_rounded(ds, k.dtype), k.to(torch.float32))
    return dq.to(q.dtype), None if ab is None else ds.to(ab.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.pcm_flash_fwd.argtypes is None:
        tail = ([ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        for fn, n_ptr in ((lib.pcm_flash_fwd, 10), (lib.pcm_flash_bwd_dkv, 13),
                          (lib.pcm_flash_bwd_dq, 13)):
            fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
            fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, ab, segment_ids, rate, seed, block_q, block_k, *extra):
    """Device, type, shape and layout checks of the kernels' wrappers."""
    _check_args(q, k, v, ab, segment_ids, rate, seed, block_q, block_k)
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev:
        raise ValueError(f"flash attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device} and {v.device}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"flash attention kernel takes f32 or bf16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype} and {v.dtype}")
    B, H, Lq, dh = q.shape
    if dh not in (64, 128) or B * H > 65535 or Lq < 1 or k.shape[2] < 1:
        raise ValueError(f"flash attention kernel takes dh in (64, 128), B*H <= "
                         f"65535 and non-empty rows, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs a contiguous last axis")
    if ab is not None and (ab.device != dev or ab.dtype != q.dtype
                           or not ab.is_contiguous()):
        raise ValueError(f"flash attention kernel takes a contiguous bias of q's "
                         f"type on {dev}")
    if segment_ids is not None and any(
            t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
            for t in segment_ids):
        raise ValueError(f"flash attention kernel takes contiguous int32 segment "
                         f"ids on {dev}")
    for name, t, shape, dtype in extra:  # do: last axis contiguous; l, m, di: all
        if tuple(t.shape) != shape or t.device != dev or t.dtype != dtype or not (
                t.stride(-1) == 1 if t.ndim == 4 else t.is_contiguous()):
            raise ValueError(f"flash attention backward: {name} must be {dtype} "
                             f"{shape} on {dev} (contiguous, or with a contiguous "
                             f"last axis for do), got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _common(q, k, ab, segment_ids, causal, block_q, block_k, sm_scale, rate, seed):
    """The pointers and scalars every entry takes after its own arguments."""
    B, H, Lq, dh = q.shape
    dropout = (_threshold(rate), _inv_keep(rate), int(seed) & _MASK32, 1) \
        if rate > 0.0 else (0, 1.0, 0, 0)
    seg = (None, None) if segment_ids is None else (segment_ids.q.data_ptr(),
                                                     segment_ids.kv.data_ptr())
    ptrs = (q.data_ptr(), None if ab is None else ab.data_ptr(), *seg)
    scalars = (B, H, Lq, k.shape[2], dh, int(causal), block_q, block_k, sm_scale,
               *dropout, int(q.dtype == torch.bfloat16), q.device.index,
               torch.cuda.current_stream(q.device).cuda_stream)
    return ptrs, scalars


def _strides(*tensors) -> ctypes.Array:
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ab: Optional[torch.Tensor] = None, segment_ids: Optional[SegmentIds] = None,
    *, causal: bool = False, sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 9: f32 or bf16 (B, H, L, dh) tensors of one type on one CUDA
    device with a contiguous last axis (other strides are read in place), dh
    64 or 128; ``ab`` contiguous of q's type, segment ids contiguous int32.
    Returns o, a (B, H, Lq, dh) view of a (B, Lq, H, dh) buffer of q's type,
    and l, m, (B, H, Lq) f32."""
    global FWD_LAUNCHES, BF16_FWD_LAUNCHES
    _check_cuda(q, k, v, ab, segment_ids, dropout_rate, dropout_seed, block_q, block_k)
    B, H, Lq, dh = q.shape
    o = _heads_view(B, Lq, H, dh, q)
    l, m = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
            for _ in range(2))
    (qp, abp, sq, skv), scalars = _common(q, k, ab, segment_ids, causal, block_q, block_k,
                                          sm_scale, dropout_rate, dropout_seed)
    err = _lib().pcm_flash_fwd(
        qp, k.data_ptr(), v.data_ptr(), abp, sq, skv, o.data_ptr(), l.data_ptr(),
        m.data_ptr(), ctypes.cast(_strides(q, k, v, o), ctypes.c_void_p), *scalars)
    _build.check(err, "flash_attention_fwd")
    if q.dtype == torch.bfloat16:
        BF16_FWD_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    return o, l, m


def _bwd_checks(q, k, v, ab, segment_ids, l, m, do, di, rate, seed, block_q, block_k):
    B, H, Lq, dh = q.shape
    f32 = torch.float32
    _check_cuda(q, k, v, ab, segment_ids, rate, seed, block_q, block_k,
                ("do", do, tuple(q.shape), q.dtype), ("l", l, (B, H, Lq), f32),
                ("m", m, (B, H, Lq), f32), ("di", di, (B, H, Lq), f32))


def flash_attention_bwd_dkv_cuda(
    q, k, v, ab, segment_ids, l, m, do, di, *, causal: bool = False,
    sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10: the forward's inputs and statistics, ``do`` (q's type and
    shape, contiguous last axis) and ``di`` (contiguous (B, H, Lq) f32) ->
    (dk, dv), (B, H, Lk, dh) views of (B, Lk, H, dh) buffers of q's type."""
    global DKV_LAUNCHES, BF16_DKV_LAUNCHES
    _bwd_checks(q, k, v, ab, segment_ids, l, m, do, di, dropout_rate, dropout_seed,
                block_q, block_k)
    B, H, Lk, dh = k.shape
    dk, dv = _heads_view(B, Lk, H, dh, q), _heads_view(B, Lk, H, dh, q)
    (qp, abp, sq, skv), scalars = _common(q, k, ab, segment_ids, causal, block_q, block_k,
                                          sm_scale, dropout_rate, dropout_seed)
    err = _lib().pcm_flash_bwd_dkv(
        qp, k.data_ptr(), v.data_ptr(), abp, sq, skv, l.data_ptr(), m.data_ptr(),
        do.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.cast(_strides(q, k, v, do, dk, dv), ctypes.c_void_p), *scalars)
    _build.check(err, "flash_attention_bwd_dkv")
    if q.dtype == torch.bfloat16:
        BF16_DKV_LAUNCHES += 1
    else:
        DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(
    q, k, v, ab, segment_ids, l, m, do, di, *, causal: bool = False,
    sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 11: as kernel 10 -> (dq, a (B, H, Lq, dh) view of a (B, Lq, H,
    dh) buffer of q's type; ds, contiguous (B, H, Lq, Lk) of ab's type, or
    None without ``ab``)."""
    global DQ_LAUNCHES, BF16_DQ_LAUNCHES
    _bwd_checks(q, k, v, ab, segment_ids, l, m, do, di, dropout_rate, dropout_seed,
                block_q, block_k)
    B, H, Lq, dh = q.shape
    dq = _heads_view(B, Lq, H, dh, q)
    # tiles the causal order skips are never written: they stay 0
    ds = None if ab is None else torch.zeros_like(ab)
    (qp, abp, sq, skv), scalars = _common(q, k, ab, segment_ids, causal, block_q, block_k,
                                          sm_scale, dropout_rate, dropout_seed)
    err = _lib().pcm_flash_bwd_dq(
        qp, k.data_ptr(), v.data_ptr(), abp, sq, skv, l.data_ptr(), m.data_ptr(),
        do.data_ptr(), di.data_ptr(), dq.data_ptr(), None if ds is None else ds.data_ptr(),
        ctypes.cast(_strides(q, k, v, do, dq), ctypes.c_void_p), *scalars)
    _build.check(err, "flash_attention_bwd_dq")
    if q.dtype == torch.bfloat16:
        BF16_DQ_LAUNCHES += 1
    else:
        DQ_LAUNCHES += 1
    return dq, ds


class _FlashAttention(torch.autograd.Function):
    """Forward by kernel 9, backward by kernels 10 and 11 (or their plain
    versions for CPU tensors); saves the inputs, o and the row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, ab, seg_q, seg_kv, opts):
        segment_ids = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
        o, l, m = fwd(q, k, v, ab, segment_ids, **opts)
        ctx.save_for_backward(q, k, v, ab, seg_q, seg_kv, o, l, m)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, ab, seg_q, seg_kv, o, l, m = ctx.saved_tensors
        segment_ids = None if seg_q is None else SegmentIds(seg_q, seg_kv)
        if do.stride(-1) != 1:
            do = do.contiguous()
        # the row term outside the kernels, as JAX takes it in XLA
        di = (o.to(torch.float32) * do.to(torch.float32)).sum(dim=-1).contiguous()
        cpu = q.device.type == "cpu"
        dkv = flash_attention_plain_bwd_dkv if cpu else flash_attention_bwd_dkv_cuda
        dq_fn = flash_attention_plain_bwd_dq if cpu else flash_attention_bwd_dq_cuda
        dk, dv = dkv(q, k, v, ab, segment_ids, l, m, do, di, **ctx.opts)
        dq, ds = dq_fn(q, k, v, ab, segment_ids, l, m, do, di, **ctx.opts)
        return dq, dk, dv, ds, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    ab: Optional[torch.Tensor] = None, segment_ids: Optional[SegmentIds] = None,
    *, causal: bool = False, sm_scale: float = 1.0, dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None, block_q: int = 128, block_k: int = 128,
) -> torch.Tensor:
    """Flash attention, (B, H, L, dh), differentiable in q, k, v and ``ab``;
    see the module docstring.

    Args:
        q: (B, H, Lq, dh); k/v: (B, H, Lk, dh), one type.
        ab: optional additive bias (B, H, Lq, Lk), added before the scale.
        segment_ids: optional :class:`SegmentIds`; a query attends to keys
            of its own segment.
        causal: a query attends to keys at or before its position.
        sm_scale: the logit scale.
        dropout_rate: attention-weight dropout in [0, 1), one mask shared by
            every batch item and head.
        dropout_seed: the mask's seed, a host integer (its low 32 bits);
            required when ``dropout_rate > 0``.
        block_q, block_k: the TPU kernels' tile, which decides the causal
            skips (``block_q`` and ``block_k``) and the blocks of the
            forward's online softmax (``block_k``); the
            defaults are the TPU's ``BlockSizes.get_default``.
    """
    opts = dict(causal=bool(causal), sm_scale=float(sm_scale),
                dropout_rate=float(dropout_rate),
                dropout_seed=None if dropout_seed is None else int(dropout_seed),
                block_q=int(block_q), block_k=int(block_k))
    seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
    return _FlashAttention.apply(q, k, v, ab, seg_q, seg_kv, opts)
