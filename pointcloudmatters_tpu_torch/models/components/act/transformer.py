"""DETR-style transformer for ACT, batch-first (port of
``pointcloudmatters_tpu/models/components/act/transformer.py:261-622``).

- ``(B, L, D)`` tokens throughout; positions are added to queries and keys
  only, never to values; LayerNorm eps 1e-5; post-norm unless
  ``normalize_before``.
- Attention modules keep flax ``MultiHeadDotProductAttention``'s
  ``query``/``key``/``value``/``out`` projections, each a ``Linear(D, D)``.
- The encoder self-attention runs the oneshot core (``ops/attention.py``),
  with ``attention_impl="flash"`` the flash core (kernels 9-11 at 1024 rows
  or more, else dense), or with ``attention_impl="fused"``
  :class:`FusedSelfAttention`; the decoder's attentions are dense, as in
  JAX, unless its layers are built with another backend (its cross
  attention then takes that core; its 100 queries keep the flash gate
  dense).
- The decoder holds all ``num_layers`` layers, so a converted checkpoint maps
  one to one, but with ``return_intermediate`` computes only the first
  ``live_layers`` (ACT reads ``hs[0]``), in training too.
- ``deterministic=False`` turns on dropout (attention weights and
  ``BitsDropout`` on the residual streams) and needs ``rngs``, the step's
  random streams: ``"dropout"`` (a generator on the tokens' device, the
  dense attention's mask, shared over the batch), ``"bits"`` (one there too,
  ``BitsDropout``'s bits, an element each) and ``"seed"`` (a CPU generator
  seeding the oneshot and flash kernels' masks).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.nn_utils import (
    BitsDropout,
    activation_fn,
)
from pointcloudmatters_tpu_torch.ops.attention import (
    dot_product_attention,
    make_flash_attention_fn,
    make_oneshot_attention_fn,
)
from pointcloudmatters_tpu_torch.ops.fused_mha import fused_mha

__all__ = [
    "MultiHeadAttention",
    "FusedSelfAttention",
    "TransformerEncoderLayer",
    "TransformerDecoderLayer",
    "TransformerEncoder",
    "TransformerDecoder",
    "Transformer",
]

_ATTENTION_IMPLS = ("dense", "flash", "oneshot", "fused")


def _attention_fn(impl: str):
    """The attention core of backend ``impl``; ``"fused"`` routes what its
    one-kernel layer does not take to the oneshot core, as in JAX."""
    if impl not in _ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {_ATTENTION_IMPLS}, got {impl!r}"
        )
    if impl == "dense":
        return dot_product_attention
    return make_flash_attention_fn() if impl == "flash" else make_oneshot_attention_fn()


def _attention_mask(key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, L) True=PAD -> (B, 1, 1, L) True=attend, or None."""
    if key_padding_mask is None:
        return None
    return ~key_padding_mask[:, None, None, :]


def _with_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pos is None else x + pos.to(x.dtype)


def _dropper(drop: BitsDropout, deterministic: bool, rngs: Optional[Mapping]):
    """``x -> drop(x)`` with the step's generator of dropout bits."""
    generator = None if deterministic or rngs is None else rngs["bits"]
    return lambda x: drop(x, deterministic, generator)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with flax's projection layout and math."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0,
                 attention_impl: str = "dense"):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.attention_fn = _attention_fn(attention_impl)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor,
                inputs_v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        B, Lq, D = inputs_q.shape
        heads = lambda x: x.view(x.shape[0], x.shape[1], self.nhead, -1)  # noqa: E731
        o = self.attention_fn(
            heads(self.query(inputs_q)), heads(self.key(inputs_k)),
            heads(self.value(inputs_v)), mask=mask,
            dropout_rate=self.dropout_rate, deterministic=deterministic, rngs=rngs,
        )
        return self.out(o.reshape(B, Lq, D))


class FusedSelfAttention(MultiHeadAttention):
    """The ``attention_impl="fused"`` encoder self-attention (JAX
    ``transformer.py:156-258``), with MultiHeadAttention's parameters.

    Routed as in JAX, by the same gate on every device: no mask, at least
    ``min_seq_len`` tokens, no dropout and the key input the query input
    itself -> the whole layer in one op, :func:`ops.fused_mha.fused_mha`
    (kernels 7 and 8 on the card); otherwise :class:`MultiHeadAttention`'s
    projections around the oneshot core (no mask, long rows: dropout
    included) or the dense math."""

    min_seq_len = 512

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0):
        super().__init__(d_model, nhead, dropout_rate, "fused")

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor,
                inputs_v: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        use_dropout = self.dropout_rate > 0.0 and not deterministic
        if (mask is None and inputs_q.shape[1] >= self.min_seq_len
                and not use_dropout and inputs_k is inputs_q):
            dt = inputs_q.dtype
            layers = (self.query, self.key, self.value, self.out)
            params = [t.to(dt) for lin in layers for t in (lin.weight.t(), lin.bias)]
            return fused_mha(inputs_q, inputs_v, *params, self.nhead)
        return super().forward(inputs_q, inputs_k, inputs_v, mask, deterministic, rngs)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, attention_impl: str = "oneshot"):
        super().__init__()
        self.normalize_before = normalize_before
        if attention_impl == "fused":
            self.self_attn = FusedSelfAttention(d_model, nhead, dropout)
        else:
            self.self_attn = MultiHeadAttention(d_model, nhead, dropout, attention_impl)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.act = activation_fn(activation)
        self.drop = BitsDropout(dropout)

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        mask = _attention_mask(key_padding_mask)
        drop = _dropper(self.drop, deterministic, rngs)

        def ffn(x):
            return self.linear2(drop(self.act(self.linear1(x))))

        def attn(qk, x):
            return self.self_attn(qk, qk, x, mask=mask, deterministic=deterministic,
                                  rngs=rngs)

        if self.normalize_before:
            x = self.norm1(src)
            src = src + drop(attn(_with_pos(x, pos), x))
            return src + drop(ffn(self.norm2(src)))
        src = src + drop(attn(_with_pos(src, pos), src))
        src = self.norm1(src)
        return self.norm2(src + drop(ffn(src)))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, attention_impl: str = "dense"):
        super().__init__()
        if attention_impl == "fused":
            raise ValueError(
                "attention_impl='fused' is encoder-self-attention only; use "
                "dense/oneshot for the decoder"
            )
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, "dense")
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout,
                                                 attention_impl)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.act = activation_fn(activation)
        self.drop = BitsDropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        mem_mask = _attention_mask(memory_key_padding_mask)
        drop = _dropper(self.drop, deterministic, rngs)
        mem_k = _with_pos(memory, pos)

        def ffn(x):
            return self.linear2(drop(self.act(self.linear1(x))))

        def self_attn(x):
            qk = _with_pos(x, query_pos)
            return self.self_attn(qk, qk, x, deterministic=deterministic, rngs=rngs)

        def cross_attn(x):
            return self.multihead_attn(_with_pos(x, query_pos), mem_k, memory,
                                       mask=mem_mask, deterministic=deterministic,
                                       rngs=rngs)

        if self.normalize_before:
            tgt = tgt + drop(self_attn(self.norm1(tgt)))
            tgt = tgt + drop(cross_attn(self.norm2(tgt)))
            return tgt + drop(ffn(self.norm3(tgt)))
        tgt = self.norm1(tgt + drop(self_attn(tgt)))
        tgt = tgt + drop(cross_attn(tgt))
        tgt = self.norm2(tgt)
        return self.norm3(tgt + drop(ffn(tgt)))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers plus a final norm when pre-norm; also the CVAE
    posterior encoder of ACT."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False,
                 num_layers: int = 4, attention_impl: str = "oneshot"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation, normalize_before, attention_impl)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=1e-5) if normalize_before else None

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, pos, key_padding_mask, deterministic, rngs)
        return src if self.norm is None else self.norm(src)


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, num_layers: int = 6,
                 return_intermediate: bool = False, attention_impl: str = "dense",
                 live_layers: Optional[int] = None):
        super().__init__()
        self.return_intermediate = return_intermediate
        self.live_layers = live_layers
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation, normalize_before, attention_impl)
            for _ in range(num_layers)
        )
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        """-> (n_run, B, nq, D) normed intermediates, or (1, B, nq, D)."""
        n_run = len(self.layers)
        if self.live_layers is not None and self.return_intermediate:
            n_run = min(self.live_layers, n_run)
        intermediate = []
        out = tgt
        for layer in self.layers[:n_run]:
            out = layer(out, memory, pos=pos, query_pos=query_pos,
                        memory_key_padding_mask=memory_key_padding_mask,
                        deterministic=deterministic, rngs=rngs)
            if self.return_intermediate:
                intermediate.append(self.norm(out))
        if self.return_intermediate:
            return torch.stack(intermediate)
        return self.norm(out)[None]


class Transformer(nn.Module):
    """ACT encoder-decoder over observation tokens.

    ``forward`` prepends ``[latent, proprio...]`` to ``src`` (with
    ``additional_pos_embed`` positions), encodes, then decodes
    ``num_queries`` zero targets against the learned query embeddings and
    returns (num_intermediate, B, num_queries, D)."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False,
                 return_intermediate_dec: bool = False,
                 attention_impl: str = "oneshot",
                 decoder_live_layers: Optional[int] = 1):
        super().__init__()
        self.d_model = d_model
        self.encoder = TransformerEncoder(
            d_model, nhead, dim_feedforward, dropout, activation,
            normalize_before, num_encoder_layers, attention_impl=attention_impl,
        )
        self.decoder = TransformerDecoder(
            d_model, nhead, dim_feedforward, dropout, activation,
            normalize_before, num_decoder_layers,
            return_intermediate=return_intermediate_dec,
            live_layers=decoder_live_layers,
        )

    def forward(self, src: torch.Tensor, query_embed: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                latent_input: Optional[torch.Tensor] = None,
                proprio_input: Optional[torch.Tensor] = None,
                additional_pos_embed: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        B = src.shape[0]
        if latent_input is not None:
            extra = [latent_input[:, None, :]]
            if proprio_input is not None:
                extra.append(proprio_input)
            addition = torch.cat(extra, dim=1)  # (B, n_add, D)
            src = torch.cat([addition, src], dim=1)
            if pos is not None and additional_pos_embed is not None:
                pos = pos.expand((B,) + pos.shape[1:])
                add_pos = additional_pos_embed[None].expand(
                    (B,) + additional_pos_embed.shape)
                pos = torch.cat([add_pos, pos], dim=1)
            if key_padding_mask is not None:
                no_pad = key_padding_mask.new_zeros((B, addition.shape[1]))
                key_padding_mask = torch.cat([no_pad, key_padding_mask], dim=1)

        memory = self.encoder(src, pos=pos, key_padding_mask=key_padding_mask,
                              deterministic=deterministic, rngs=rngs)
        query_pos = query_embed[None].expand(B, -1, -1)
        tgt = torch.zeros_like(query_pos)
        return self.decoder(tgt, memory, pos=pos, query_pos=query_pos,
                            memory_key_padding_mask=key_padding_mask,
                            deterministic=deterministic, rngs=rngs)
