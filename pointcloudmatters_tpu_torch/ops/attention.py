"""Attention cores for the ACT transformer (port of
``pointcloudmatters_tpu/ops/attention.py``).

All take and return flax's ``(B, L, H, dh)`` layout, the layout of the
projected query/key/value the transformer produces.

``make_oneshot_attention_fn`` keeps the JAX dispatch rule
(``attention.py:107-119``): the oneshot core only when there is no mask and
the key row has at least ``min_seq_len`` keys; otherwise the dense math of
``flax.linen.dot_product_attention`` in explicit matmuls and a softmax.

``make_flash_attention_fn`` keeps the JAX flash gate (``attention.py:
170-185``) on every device: the flash core (kernels 9-11) only with no
bias, a key-padding mask at most and ``min(Lq, Lk) >= min_seq_len``;
otherwise the dense math. Unlike the JAX adapter it pads nothing: padded
keys would weigh exactly 0 there (the mask value's exp) and padded queries
are sliced off, so the unpadded rows compute the same thing; kv segment ids
are built only from a mask.

Dropout (``deterministic=False`` and a rate > 0) needs the step's random
streams, a mapping with ``"dropout"`` (a ``torch.Generator`` on the tensors'
device) and ``"seed"`` (a CPU ``torch.Generator`` that seeds the oneshot
kernel's mask, so that drawing it never waits for the device):

- dense: flax's ``broadcast_dropout=True``, one ``(Lq, Lk)`` Bernoulli
  (1 - rate) mask shared across batch and heads, survivors scaled by
  ``1 / (1 - rate)``, applied to the softmax weights (under data
  parallelism ``"dropout"`` is seeded alike on every rank, so the mask is
  shared across the ranks' rows too, as one global draw is under GSPMD);
- oneshot: the kernel's mask, one per head and shared across the batch,
  on the CPU as on the card (the JAX package's CPU fallback takes the dense
  broadcast instead; the port keeps the kernel's semantics everywhere);
- flash: the flash kernels' mask, one shared across batch and heads,
  seeded from ``"seed"`` as well.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch

from pointcloudmatters_tpu_torch.ops.flash_attention import SegmentIds, flash_attention
from pointcloudmatters_tpu_torch.ops.oneshot_attention import (
    oneshot_attention,
    rounded_scalar,
)

__all__ = [
    "dot_product_attention",
    "make_oneshot_attention_fn",
    "make_flash_attention_fn",
    "draw_seed",
    "FLASH_TILE",
    "flash_token_padding",
]

# the flash core's default (q, kv) tile edge, as in JAX
FLASH_TILE = 512


def flash_token_padding(seq_len: int) -> int:
    """Padded sequence length the JAX flash path would use for ``seq_len``
    (the port's adapter pads nothing)."""
    return -(-seq_len // FLASH_TILE) * FLASH_TILE


def _use_dropout(dropout_rate: float, deterministic: bool,
                 rngs: Optional[Mapping]) -> bool:
    if dropout_rate <= 0.0 or deterministic:
        return False
    if rngs is None:
        raise ValueError("attention dropout needs the step's random streams "
                         "(rngs with 'dropout' and 'seed' generators)")
    return True


def draw_seed(generator: torch.Generator) -> int:
    """A 32-bit kernel seed from a CPU generator (no device sync)."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator))


def dot_product_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    deterministic: bool = True, rngs: Optional[Mapping] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense ``softmax(q k^T / sqrt(dh) + bias) v`` over (B, L, H, dh)
    tensors; ``mask`` (broadcastable to (B, H, Lq, Lk), True = attend) sets
    masked logits to the dtype's minimum, as flax does. Every step stays in
    the inputs' type, with its constants rounded to it (flax's
    ``dot_product_attention`` under bf16)."""
    dt = query.dtype
    q = query / rounded_scalar(math.sqrt(query.shape[-1]), dt)
    s = torch.matmul(q.transpose(1, 2), key.permute(0, 2, 3, 1))
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    if _use_dropout(dropout_rate, deterministic, rngs):
        keep_prob = 1.0 - dropout_rate
        keep = torch.rand(s.shape[-2:], generator=rngs["dropout"],
                          device=s.device) < keep_prob
        p = p * (keep.to(dt) / rounded_scalar(keep_prob, dt))
    return torch.matmul(p, value.transpose(1, 2)).transpose(1, 2)


def make_oneshot_attention_fn(min_seq_len: int = 512):
    """Attention core backed by the oneshot kernels
    (:mod:`pointcloudmatters_tpu_torch.ops.oneshot_attention`), with the
    dense math for masked or short key rows."""

    def attention_fn(
        query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        deterministic: bool = True, rngs: Optional[Mapping] = None,
    ) -> torch.Tensor:
        if mask is not None or key.shape[1] < min_seq_len:
            return dot_product_attention(query, key, value, mask, dropout_rate,
                                         deterministic, rngs)
        rate, seed = 0.0, 0
        if _use_dropout(dropout_rate, deterministic, rngs):
            rate, seed = dropout_rate, draw_seed(rngs["seed"])
        out = oneshot_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
            query.shape[-1] ** -0.5, rate=rate, seed=seed,
        )
        return out.transpose(1, 2)

    return attention_fn


def make_flash_attention_fn(block_q: int = FLASH_TILE, block_k: int = FLASH_TILE,
                            min_seq_len: int = 1024):
    """Attention core backed by the flash kernels
    (:mod:`pointcloudmatters_tpu_torch.ops.flash_attention`), with the dense
    math for a bias, a mask other than a key-padding one ((B, 1, 1, Lk) or
    (B, H, 1, Lk), whose first head is read, as in JAX) and rows shorter
    than ``min_seq_len`` on either side (the ACT decoder and the CVAE
    posterior)."""

    def attention_fn(
        query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        deterministic: bool = True, rngs: Optional[Mapping] = None,
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        B, Lq, H, dh = query.shape
        Lk = key.shape[1]
        key_padding = mask is None or (mask.ndim == 4 and mask.shape[-2] == 1)
        if bias is not None or not key_padding or min(Lq, Lk) < min_seq_len:
            return dot_product_attention(query, key, value, mask, dropout_rate,
                                         deterministic, rngs, bias=bias)
        rate, seed = 0.0, None
        if _use_dropout(dropout_rate, deterministic, rngs):
            rate, seed = dropout_rate, draw_seed(rngs["seed"])
        segment_ids = None
        if mask is not None:  # True = attend -> id 1, like every query's
            kv = mask[:, 0, 0, :].to(torch.int32).expand(B, Lk).contiguous()
            segment_ids = SegmentIds(torch.ones((B, Lq), dtype=torch.int32,
                                                device=query.device), kv)
        out = flash_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
            segment_ids=segment_ids, sm_scale=dh ** -0.5, dropout_rate=rate,
            dropout_seed=seed, block_q=min(block_q, Lq), block_k=min(block_k, Lk),
        )
        return out.transpose(1, 2)

    return attention_fn
