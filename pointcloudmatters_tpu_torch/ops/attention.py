"""Attention cores for the ACT transformer (port of
``pointcloudmatters_tpu/ops/attention.py:74-135``).

Both take and return flax's ``(B, L, H, dh)`` layout, the layout of the
projected query/key/value the transformer produces.

``make_oneshot_attention_fn`` keeps the JAX dispatch rule
(``attention.py:107-119``): the oneshot core only when there is no mask and
the key row has at least ``min_seq_len`` keys; otherwise the dense math of
``flax.linen.dot_product_attention`` in explicit matmuls and a softmax.
Dropout inside attention comes with the training step and raises here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pointcloudmatters_tpu_torch.ops.oneshot_attention import oneshot_attention

__all__ = ["dot_product_attention", "make_oneshot_attention_fn"]


def _no_dropout(dropout_rate: float, deterministic: bool) -> None:
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "attention dropout comes with the training step; call with "
            "deterministic=True or dropout_rate=0"
        )


def dot_product_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
    mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    deterministic: bool = True,
) -> torch.Tensor:
    """Dense ``softmax(q k^T / sqrt(dh)) v`` over (B, L, H, dh) tensors;
    ``mask`` (broadcastable to (B, H, Lq, Lk), True = attend) sets masked
    logits to the dtype's minimum, as flax does."""
    _no_dropout(dropout_rate, deterministic)
    q = query / math.sqrt(query.shape[-1])
    s = torch.matmul(q.transpose(1, 2), key.permute(0, 2, 3, 1))
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, value.transpose(1, 2)).transpose(1, 2)


def make_oneshot_attention_fn(min_seq_len: int = 512):
    """Attention core backed by the oneshot kernel
    (:mod:`pointcloudmatters_tpu_torch.ops.oneshot_attention`), with the
    dense math for masked or short key rows."""

    def attention_fn(
        query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        deterministic: bool = True,
    ) -> torch.Tensor:
        _no_dropout(dropout_rate, deterministic)
        if mask is not None or key.shape[1] < min_seq_len:
            return dot_product_attention(query, key, value, mask=mask)
        out = oneshot_attention(
            query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
            query.shape[-1] ** -0.5,
        )
        return out.transpose(1, 2)

    return attention_fn
