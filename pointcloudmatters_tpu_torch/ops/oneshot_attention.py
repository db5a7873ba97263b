"""Exact softmax attention for the ACT encoder (port of
``pointcloudmatters_tpu/ops/oneshot_attention.py:68-94, 176-230``).

Layout ``(B, H, L, dh)``, f32. q is scaled by ``scale`` before the product
(the TPU path pre-scales q), keys at column ``l_actual`` and beyond are
masked, and the output is ``(e @ v) * (1 / sum(e))`` with
``e = exp(s - max(s))``, as in the TPU kernel.

A CPU tensor runs :func:`oneshot_attention_plain`; a CUDA tensor the
hand-written kernel ``csrc/attention_fwd.cu`` (design notes in its source),
which raises on anything it does not take. Only the forward at dropout rate
0 exists: the backward and the in-kernel dropout mask come with the
training step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pointcloudmatters_tpu_torch import _build

__all__ = [
    "oneshot_attention",
    "oneshot_attention_plain",
    "oneshot_attention_cuda",
    "LAUNCHES",
]

NEG_INF = -1e30

# launches of the kernel in this process; a caller may reset it to 0
LAUNCHES = 0


def oneshot_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    l_actual: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, H, Lq, dh) x (B, H, Lk, dh)
    -> (B, H, Lq, dh)."""
    Lk = k.shape[2]
    l_actual = Lk if l_actual is None else l_actual
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    col = torch.arange(Lk, device=q.device)
    s = torch.where(col < l_actual, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    return torch.matmul(e, v) * (1.0 / denom)


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    if lib.pcm_attention_fwd.argtypes is None:
        lib.pcm_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
        )
        lib.pcm_attention_fwd.restype = ctypes.c_int
    return lib


def oneshot_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    l_actual: Optional[int] = None,
) -> torch.Tensor:
    """The CUDA kernel: f32 (B, H, L, dh) tensors on one CUDA device whose
    last axis is contiguous (any other strides are read in place), dh 64 or
    128. Returns a (B, H, Lq, dh) view of a (B, Lq, H, dh) buffer, so that
    merging the heads afterwards copies nothing."""
    global LAUNCHES
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
    out = torch.empty((B, Lq, H, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    if Lq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().pcm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, H, Lq, Lk, dh, l_actual, float(scale), dev.index, stream,
    )
    _build.check(err, "attention_fwd")
    LAUNCHES += 1
    return out


def oneshot_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    rate: float = 0.0, l_actual: Optional[int] = None,
) -> torch.Tensor:
    """Exact softmax attention, (B, H, L, dh); see the module docstring.

    Args:
        q: (B, H, Lq, dh); k/v: (B, H, Lk, dh).
        scale: logit scale (1/sqrt(dh)).
        rate: attention-weight dropout rate; only 0 exists yet.
        l_actual: keys at this column and beyond are masked (default Lk).
    """
    if rate > 0.0:
        raise NotImplementedError(
            "oneshot attention dropout (the TPU kernel's `_keep_mask`) comes "
            "with the training step; only rate 0 is ported"
        )
    if q.device.type == "cpu":
        return oneshot_attention_plain(q, k, v, scale, l_actual)
    return oneshot_attention_cuda(q, k, v, scale, l_actual)
