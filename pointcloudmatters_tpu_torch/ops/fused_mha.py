"""One self-attention layer, projections included: the ``attention_impl=
"fused"`` encoder's op (port of ``pointcloudmatters_tpu/ops/fused_mha.py``).

``out = heads(x_qk, x_v) @ wo + bo`` with ``q = x_qk @ wq + bq``,
``k = x_qk @ wk + bk``, ``v = x_v @ wv + bv`` split into ``nhead`` heads of
``dh = D // nhead`` and exact softmax attention per head. Weights are
``(D_in, D_out)``, as JAX multiplies ``x @ W``; the kernels read any strides
of them, so ``nn.Linear.weight.t()`` (a view) is read in place. Inputs are
f32 or bf16, all of one type.

The TPU kernel rounds to bf16 whatever the input type, and so do these
versions, at its points (``fused_mha.py:59-117, 206-403``); every sum and
product is f32 with the operands' values:

- forward: ``k = bf16(x_qk wk + bk)``, ``v = bf16(x_v wv + bv)``,
  ``q = bf16((x_qk wq + bq) * scale)`` (``scale = dh ** -0.5`` in f32 before
  the one rounding); per head ``e = exp(s - max s)`` against the row's final
  max, ``denom = sum e`` before dropout, ``e <- keep ? e / (1 - rate) : 0``,
  ``head = bf16((bf16(e) @ v) * (1 / denom))``; ``out = heads @ wo + bo`` in
  the input type;
- backward (the forward saves only its inputs; q, k, v and the row
  statistics are recomputed): ``dheads = bf16(dO wo^T)``, ``r = 1 / denom``,
  ``p_drop = keep ? e (inv r) : 0``, ``dv = bf16(p_drop)^T dheads``,
  ``dp = dheads v^T``, ``z = keep ? dp (inv r) : 0``,
  ``u = r * sum(z * e)`` from the unrounded e and z, ``ds = bf16(e (z - u))``,
  ``dq = ds k``, ``dk = ds q``; ``dq_lin = dq * scale`` unrounded; input
  gradients ``bf16(dq_lin) wq^T + bf16(dk) wk^T`` (summed in f32, then cast)
  and ``bf16(dv) wv^T``; weight gradients ``x^T bf16(d.)`` and ``heads^T dO``;
  bias gradients the unrounded f32 sums of dq_lin, dk, dv and dO. Every
  weight and bias gradient comes back in its parameter's type.

Dropout uses the oneshot kernels' mask (:func:`oneshot_attention.keep_mask`,
``csrc/philox.cuh``): one per head, shared across the batch, a function of
(seed, head, query row, key column). For a seed, the fused op and the
composed route (projections + :func:`oneshot_attention`) therefore draw the
same mask, as the JAX docstring promises (``fused_mha.py:13-16``).

:func:`fused_mha` is an autograd function. A CPU tensor runs the plain
versions (:func:`fused_mha_plain`, :func:`fused_mha_plain_bwd`); a CUDA
tensor the hand-written kernels of ``csrc/fused_mha.cu`` (design notes
there), which raise on anything they do not take.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops.oneshot_attention import (
    _check_rate,
    _dropout_args,
    keep_mask,
)

__all__ = [
    "fused_mha",
    "fused_mha_plain",
    "fused_mha_plain_bwd",
    "fused_mha_cuda",
    "fused_mha_bwd_cuda",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "BF16_LAUNCHES",
    "BF16_BWD_LAUNCHES",
]

_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_F32 = torch.float32

# launches of the forward and backward kernels in this process, f32 and bf16
# instances apart; a caller may reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0


def _bf(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to bf16, held in f32."""
    return x.to(_BF16).to(_F32)


def _heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, dh)."""
    B, L, D = x.shape
    return x.reshape(B, L, nhead, D // nhead).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, dh) -> (B, L, D)."""
    B, H, L, dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * dh)


def _project(x, w, b) -> torch.Tensor:
    """``x @ w + b`` in f32 from the operands' values."""
    return torch.matmul(x.to(_F32), w.to(_F32)) + b.to(_F32)


def _qkv(x_qk, x_v, wq, bq, wk, bk, wv, bv, nhead):
    """The bf16-rounded (B, H, L, dh) q (pre-scaled), k and v, in f32."""
    scale = (x_qk.shape[-1] // nhead) ** -0.5
    q = _bf(_project(x_qk, wq, bq) * scale)
    k = _bf(_project(x_qk, wk, bk))
    v = _bf(_project(x_v, wv, bv))
    return _heads(q, nhead), _heads(k, nhead), _heads(v, nhead), scale


def _softmax_terms(q, k, rate, seed):
    """e = exp(s - rowmax s) (B, H, L, L), r = 1 / rowsum e, and the keep
    mask (H, L, L) or None."""
    H, L = q.shape[1], q.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    keep = keep_mask(seed, rate, H, L, L, device=q.device) if rate > 0.0 else None
    return e, r, keep


def fused_mha_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, nhead: int,
                    rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels: (B, L, D) -> (B, L, D)
    in the inputs' type (see the module docstring)."""
    _check_rate(rate)
    q, k, v, _ = _qkv(x_qk, x_v, wq, bq, wk, bk, wv, bv, nhead)
    e, r, keep = _softmax_terms(q, k, rate, seed)
    if keep is not None:
        e = torch.where(keep, e * (1.0 / (1.0 - rate)), 0.0)
    heads = _bf(torch.matmul(_bf(e), v) * r)
    return _project(_merge(heads), wo, bo).to(x_qk.dtype)


def fused_mha_plain_bwd(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, dout,
                        nhead: int, rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the backward kernels -> (dx_qk, dx_v, dwq,
    dbq, dwk, dbk, dwv, dbv, dwo, dbo), each in its input's type."""
    _check_rate(rate)
    dt = x_qk.dtype
    q, k, v, scale = _qkv(x_qk, x_v, wq, bq, wk, bk, wv, bv, nhead)
    do = dout.to(dt).to(_F32)
    dheads = _heads(_bf(torch.matmul(do, wo.to(_F32).T)), nhead)
    e, r, keep = _softmax_terms(q, k, rate, seed)
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        e_drop = torch.where(keep, e * inv, 0.0)
        p_drop = torch.where(keep, e * (inv * r), 0.0)
    else:
        e_drop, p_drop = e, e * r
    heads = _merge(_bf(torch.matmul(_bf(e_drop), v) * r))
    dv = torch.matmul(_bf(p_drop).transpose(-1, -2), dheads)
    dp = torch.matmul(dheads, v.transpose(-1, -2))
    z = torch.where(keep, dp * (inv * r), 0.0) if keep is not None else dp * r
    u = r * (z * e).sum(dim=-1, keepdim=True)
    ds = _bf(e * (z - u))
    dq_lin = _merge(torch.matmul(ds, k)) * scale
    dk = _merge(torch.matmul(ds.transpose(-1, -2), q))
    dv = _merge(dv)

    def t(w):  # w^T in f32
        return w.to(_F32).T

    def wgrad(x, g):  # sum over batch and rows of x^T g
        return torch.matmul(x.to(_F32).reshape(-1, x.shape[-1]).T,
                            g.reshape(-1, g.shape[-1]))

    dq_bf, dk_bf, dv_bf = _bf(dq_lin), _bf(dk), _bf(dv)
    dx_qk = (torch.matmul(dq_bf, t(wq)) + torch.matmul(dk_bf, t(wk))).to(dt)
    dx_v = torch.matmul(dv_bf, t(wv)).to(x_v.dtype)
    rows = (0, 1)
    return (dx_qk, dx_v,
            wgrad(x_qk, dq_bf).to(wq.dtype), dq_lin.sum(rows).to(bq.dtype),
            wgrad(x_qk, dk_bf).to(wk.dtype), dk.sum(rows).to(bk.dtype),
            wgrad(x_v, dv_bf).to(wv.dtype), dv.sum(rows).to(bv.dtype),
            wgrad(heads, do).to(wo.dtype), do.sum(rows).to(bo.dtype))


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mha")
    for fn in (lib.pcm_fused_mha_fwd, lib.pcm_fused_mha_bwd):
        if fn.argtypes is None:
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return lib


def _check(x_qk, x_v, weights, biases, nhead, rate) -> tuple[int, int, int]:
    """Device, type and shape checks of both kernels -> (B, L, D)."""
    dev, dt = x_qk.device, x_qk.dtype
    tensors = (x_qk, x_v, *weights, *biases)
    if not x_qk.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_mha kernel needs every tensor on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"fused_mha kernel takes f32 or bf16 tensors of one type, "
                        f"got {sorted({str(t.dtype) for t in tensors})}")
    if x_qk.ndim != 3 or x_v.shape != x_qk.shape:
        raise ValueError(f"fused_mha kernel takes x_qk and x_v of one (B, L, D) "
                         f"shape, got {tuple(x_qk.shape)} and {tuple(x_v.shape)}")
    B, L, D = x_qk.shape
    if nhead < 1 or D % nhead or D // nhead not in (64, 128) or B * nhead > 65535:
        raise ValueError(f"fused_mha kernel takes dh = D / nhead in (64, 128) and "
                         f"B * nhead <= 65535, got D={D}, nhead={nhead}, B={B}")
    if not (x_qk.is_contiguous() and x_v.is_contiguous()
            and all(b.is_contiguous() for b in biases)):
        raise ValueError("fused_mha kernel needs contiguous x_qk, x_v and biases")
    if any(w.shape != (D, D) for w in weights) or any(b.shape != (D,) for b in biases):
        raise ValueError(f"fused_mha kernel takes (D, D) weights and (D,) biases, "
                         f"D={D}")
    _check_rate(rate)
    return B, L, D


def _ptrs(*tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _wstrides(*weights) -> ctypes.Array:
    return (ctypes.c_longlong * (2 * len(weights)))(
        *[s for w in weights for s in w.stride()])


def _scalars(B, L, D, nhead, rate, seed, dt, dev) -> tuple:
    return (B, L, D, nhead, _splits(B * L), (D // nhead) ** -0.5,
            *_dropout_args(rate, seed), int(dt == _BF16), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)


def _splits(rows: int) -> int:
    """Row splits of the weight- and bias-gradient reductions: a function of
    the shape alone, so that the sums keep one order."""
    return max(1, min(16, rows // 512))


def fused_mha_cuda(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, nhead: int,
                   rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """The forward kernels: contiguous (B, L, D) x_qk and x_v, (D, D) weights
    of any strides and contiguous (D,) biases, all f32 or all bf16 on one
    CUDA device, dh = D / nhead 64 or 128. Returns (B, L, D) in their type."""
    global LAUNCHES, BF16_LAUNCHES
    B, L, D = _check(x_qk, x_v, (wq, wk, wv, wo), (bq, bk, bv, bo), nhead, rate)
    dev, dt = x_qk.device, x_qk.dtype
    out = torch.empty_like(x_qk)
    if L == 0:
        return out
    scratch = torch.empty((4, B, L, D), dtype=_BF16, device=dev)  # q, k, v, heads
    ptrs = _ptrs(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, scratch, out)
    err = _lib().pcm_fused_mha_fwd(
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(_wstrides(wq, wk, wv, wo), ctypes.c_void_p),
        *_scalars(B, L, D, nhead, rate, seed, dt, dev))
    _build.check(err, "fused_mha_fwd")
    if dt == _BF16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def fused_mha_bwd_cuda(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, dout,
                       nhead: int, rate: float = 0.0, seed: int = 0):
    """The backward kernels: the forward's inputs and ``dout`` (contiguous,
    their shape and type) -> (dx_qk, dx_v, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
    dbo), each contiguous in its input's type and shape. Same constraints as
    the forward."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    B, L, D = _check(x_qk, x_v, (wq, wk, wv, wo), (bq, bk, bv, bo), nhead, rate)
    dev, dt = x_qk.device, x_qk.dtype
    if dout.shape != x_qk.shape or dout.dtype != dt or dout.device != dev \
            or not dout.is_contiguous():
        raise ValueError(f"fused_mha backward: dout must be contiguous {dt} "
                         f"{tuple(x_qk.shape)} on {dev}")
    grads = [torch.empty_like(x_qk), torch.empty_like(x_v)] + [
        torch.empty(t.shape, dtype=dt, device=dev) for t in (wq, bq, wk, bk, wv, bv, wo, bo)]
    if L == 0:
        return tuple(g.zero_() for g in grads)
    S = _splits(B * L)
    H = nhead
    # q k v dheads heads, and the bf16 dq_lin dk dv that the GEMMs read
    bf_scratch = torch.empty((8, B, L, D), dtype=_BF16, device=dev)
    f32_scratch = torch.empty((4, B, L, D), dtype=_F32, device=dev)  # dq dk dv dxk
    stats = torch.empty((3, B, H, L), dtype=_F32, device=dev)        # m r u
    parts = torch.empty((4, S, D * D + D), dtype=_F32, device=dev)   # dW, db partials
    ptrs = _ptrs(x_qk, x_v, dout, wq, bq, wk, bk, wv, bv, wo,
                 bf_scratch, f32_scratch, stats, parts, *grads)
    err = _lib().pcm_fused_mha_bwd(
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(_wstrides(wq, wk, wv, wo), ctypes.c_void_p),
        *_scalars(B, L, D, nhead, rate, seed, dt, dev))
    _build.check(err, "fused_mha_bwd")
    if dt == _BF16:
        BF16_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return tuple(grads)


class _FusedMHA(torch.autograd.Function):
    """Forward by kernel 7, backward by kernel 8 (or their plain versions
    for CPU tensors); saves the inputs only, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, nhead, rate, seed):
        fwd = fused_mha_plain if x_qk.device.type == "cpu" else fused_mha_cuda
        ctx.save_for_backward(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.args = (nhead, rate, seed)
        return fwd(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, nhead, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        inputs = ctx.saved_tensors
        bwd = fused_mha_plain_bwd if inputs[0].device.type == "cpu" else fused_mha_bwd_cuda
        return (*bwd(*inputs, dout.contiguous(), *ctx.args), None, None, None)


def fused_mha(x_qk: torch.Tensor, x_v: torch.Tensor, wq: torch.Tensor,
              bq: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
              wv: torch.Tensor, bv: torch.Tensor, wo: torch.Tensor,
              bo: torch.Tensor, nhead: int, rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """One self-attention layer, differentiable in every tensor argument;
    see the module docstring.

    Args:
        x_qk: (B, L, D) query/key input (the positioned token row).
        x_v: (B, L, D) value input (the un-positioned row).
        wq/wk/wv/wo: (D_in, D_out) weights; bq/bk/bv/bo: (D,) biases.
        nhead: head count (D % nhead == 0).
        rate: attention-weight dropout rate in [0, 1).
        seed: the dropout mask's seed, a host integer (its low 32 bits).
    """
    return _FusedMHA.apply(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, int(nhead),
                           float(rate), int(seed))
