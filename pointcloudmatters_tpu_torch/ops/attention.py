"""Attention cores for the ACT transformer (port of
``pointcloudmatters_tpu/ops/attention.py:74-135``).

Both take and return flax's ``(B, L, H, dh)`` layout, the layout of the
projected query/key/value the transformer produces.

``make_oneshot_attention_fn`` keeps the JAX dispatch rule
(``attention.py:107-119``): the oneshot core only when there is no mask and
the key row has at least ``min_seq_len`` keys; otherwise the dense math of
``flax.linen.dot_product_attention`` in explicit matmuls and a softmax.

Dropout (``deterministic=False`` and a rate > 0) needs the step's random
streams, a mapping with ``"dropout"`` (a ``torch.Generator`` on the tensors'
device) and ``"seed"`` (a CPU ``torch.Generator`` that seeds the oneshot
kernel's mask, so that drawing it never waits for the device):

- dense: flax's ``broadcast_dropout=True``, one ``(Lq, Lk)`` Bernoulli
  (1 - rate) mask shared across batch and heads, survivors scaled by
  ``1 / (1 - rate)``, applied to the softmax weights;
- oneshot: the kernel's mask, one per head and shared across the batch,
  on the CPU as on the card (the JAX package's CPU fallback takes the dense
  broadcast instead; the port keeps the kernel's semantics everywhere).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Optional

import torch

from pointcloudmatters_tpu_torch.ops.oneshot_attention import (
    oneshot_attention,
    rounded_scalar,
)

__all__ = ["dot_product_attention", "make_oneshot_attention_fn", "draw_seed"]


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
) -> torch.Tensor:
    """Dense ``softmax(q k^T / sqrt(dh)) v`` over (B, L, H, dh) tensors;
    ``mask`` (broadcastable to (B, H, Lq, Lk), True = attend) sets masked
    logits to the dtype's minimum, as flax does. Every step stays in the
    inputs' type, with its constants rounded to it (flax's
    ``dot_product_attention`` under bf16)."""
    dt = query.dtype
    q = query / rounded_scalar(math.sqrt(query.shape[-1]), dt)
    s = torch.matmul(q.transpose(1, 2), key.permute(0, 2, 3, 1))
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
