"""Transformer action denoiser, the alternative to ConditionalUnet1D (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/diffusion/
transformer_for_diffusion.py``; no config selects it, in the reference too).

A sinusoidal time embedding (and, with ``cond_dim``, observation tokens)
forms a memory that cross-conditions a decoder, optionally causal, over the
noisy action trajectory; with ``time_as_cond`` off it is a BERT-style
encoder over ``[time, actions]``. Batch-first throughout. flax's defaults,
kept: ``LayerNorm`` eps 1e-6, ``gelu`` in its tanh form, attention with
separate ``query``/``key``/``value``/``out`` projections (the port's
``MultiHeadAttention``, dense, its weights' dropout shared over batch and
heads) and a boolean mask that is True where a query attends (the causal
mask is the lower triangle), Mish as ``x * tanh(softplus(x))``.
Module and parameter names are the JAX module's (``decoder_<i>``,
``cond_pos_emb``, ``pos_emb``, ``ln_f``, ``head``, ...).

``forward(sample, timestep, cond=None, train=False, rngs=None)``: sample
(B, T, input_dim), timestep a scalar or (B,), cond (B, To, cond_dim);
training with dropout needs ``rngs["dropout"]``, a generator on the
sample's device.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.act.transformer import MultiHeadAttention
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.conditional_unet1d import (  # noqa: E501
    SinusoidalPosEmb,
)

__all__ = ["TransformerForDiffusion"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _dropout(x: torch.Tensor, rate: float, train: bool,
             rngs: Optional[Mapping]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with ``1 - rate``, survivors
    scaled by ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    if rngs is None:
        raise ValueError("TransformerForDiffusion in training needs rngs['dropout']")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rngs["dropout"], device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class _EncLayer(nn.Module):
    """Pre-norm self-attention and GELU MLP block."""

    def __init__(self, n_emb: int, n_head: int, p_drop: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(n_emb, eps=1e-6)
        self.attn = MultiHeadAttention(n_emb, n_head, p_drop)
        self.norm2 = nn.LayerNorm(n_emb, eps=1e-6)
        self.fc1 = nn.Linear(n_emb, 4 * n_emb)
        self.fc2 = nn.Linear(4 * n_emb, n_emb)

    def forward(self, x, mask=None, train: bool = False, rngs=None):
        y = self.norm1(x)
        x = x + self.attn(y, y, y, mask=mask, deterministic=not train, rngs=rngs)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class _DecLayer(nn.Module):
    """Pre-norm self-attention, cross-attention to the memory, GELU MLP."""

    def __init__(self, n_emb: int, n_head: int, p_drop: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(n_emb, eps=1e-6)
        self.self_attn = MultiHeadAttention(n_emb, n_head, p_drop)
        self.norm2 = nn.LayerNorm(n_emb, eps=1e-6)
        self.cross_attn = MultiHeadAttention(n_emb, n_head, p_drop)
        self.norm3 = nn.LayerNorm(n_emb, eps=1e-6)
        self.fc1 = nn.Linear(n_emb, 4 * n_emb)
        self.fc2 = nn.Linear(4 * n_emb, n_emb)

    def forward(self, x, memory, self_mask=None, train: bool = False, rngs=None):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y, mask=self_mask, deterministic=not train, rngs=rngs)
        y = self.norm2(x)
        x = x + self.cross_attn(y, memory, memory, deterministic=not train, rngs=rngs)
        return x + self.fc2(_gelu(self.fc1(self.norm3(x))))


class TransformerForDiffusion(nn.Module):
    """The denoiser (module doc); the JAX module's fields, widths given."""

    def __init__(self, input_dim: int, output_dim: int, horizon: int,
                 n_obs_steps: Optional[int] = None, cond_dim: int = 0, n_layer: int = 12,
                 n_head: int = 12, n_emb: int = 768, p_drop_emb: float = 0.1,
                 p_drop_attn: float = 0.1, causal_attn: bool = False,
                 time_as_cond: bool = True, obs_as_cond: bool = False,
                 n_cond_layers: int = 0):
        super().__init__()
        self.horizon = horizon
        self.n_obs_steps = n_obs_steps
        self.cond_dim = cond_dim
        self.n_layer = n_layer
        self.n_emb = n_emb
        self.p_drop_emb = p_drop_emb
        self.causal_attn = causal_attn
        self.time_as_cond = time_as_cond
        self.obs_as_cond = obs_as_cond  # the JAX field; cond_dim > 0 decides
        self.n_cond_layers = n_cond_layers
        self.time_pos = SinusoidalPosEmb(n_emb)
        self.time_fc1 = nn.Linear(n_emb, 4 * n_emb)
        self.time_fc2 = nn.Linear(4 * n_emb, n_emb)
        self.input_emb = nn.Linear(input_dim, n_emb)
        if not time_as_cond:
            self.pos_emb = nn.Parameter(torch.zeros(1, horizon + 1, n_emb))
            for i in range(n_layer):
                self.add_module(f"encoder_{i}", _EncLayer(n_emb, n_head, p_drop_attn))
        else:
            if cond_dim > 0:
                self.cond_obs_emb = nn.Linear(cond_dim, n_emb)
            self.cond_pos_emb = nn.Parameter(torch.zeros(1, 1 + (n_obs_steps or horizon), n_emb))
            if n_cond_layers > 0:
                for i in range(n_cond_layers):
                    self.add_module(f"cond_encoder_{i}", _EncLayer(n_emb, n_head, p_drop_attn))
            else:
                self.cond_mlp1 = nn.Linear(n_emb, 4 * n_emb)
                self.cond_mlp2 = nn.Linear(4 * n_emb, n_emb)
            self.pos_emb = nn.Parameter(torch.zeros(1, horizon, n_emb))
            for i in range(n_layer):
                self.add_module(f"decoder_{i}", _DecLayer(n_emb, n_head, p_drop_attn))
        self.ln_f = nn.LayerNorm(n_emb, eps=1e-6)
        self.head = nn.Linear(n_emb, output_dim)

    def forward(self, sample: torch.Tensor, timestep, cond: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Optional[Mapping] = None) -> torch.Tensor:
        B, T = sample.shape[0], sample.shape[1]
        timesteps = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(B)
        # the f32 sinusoids cast before the MLP, as in JAX, so that the
        # time token does not promote a bf16 transformer to f32
        time_emb = self.time_fc1(self.time_pos(timesteps).to(sample.dtype))
        time_emb = self.time_fc2(_mish(time_emb))[:, None, :]
        input_emb = self.input_emb(sample)

        def drop(x):
            return _dropout(x, self.p_drop_emb, train, rngs)

        if not self.time_as_cond:  # BERT-style encoder-only
            tokens = torch.cat([time_emb, input_emb], dim=1)
            x = drop(tokens + self.pos_emb[:, :tokens.shape[1]].to(tokens.dtype))
            mask = None
            if self.causal_attn:
                L = tokens.shape[1]
                mask = torch.tril(torch.ones((1, 1, L, L), dtype=torch.bool, device=x.device))
            for i in range(self.n_layer):
                x = getattr(self, f"encoder_{i}")(x, mask=mask, train=train, rngs=rngs)
            x = x[:, 1:]
        else:
            cond_tokens = time_emb
            if self.cond_dim > 0:
                cond_tokens = torch.cat([cond_tokens, self.cond_obs_emb(cond)], dim=1)
            memory = drop(cond_tokens
                          + self.cond_pos_emb[:, :cond_tokens.shape[1]].to(cond_tokens.dtype))
            if self.n_cond_layers > 0:
                for i in range(self.n_cond_layers):
                    memory = getattr(self, f"cond_encoder_{i}")(memory, train=train, rngs=rngs)
            else:
                memory = self.cond_mlp2(_mish(self.cond_mlp1(memory)))
            causal = None
            if self.causal_attn:
                causal = torch.tril(torch.ones((1, 1, T, T), dtype=torch.bool,
                                               device=sample.device))
            x = drop(input_emb + self.pos_emb[:, :T].to(input_emb.dtype))
            for i in range(self.n_layer):
                x = getattr(self, f"decoder_{i}")(x, memory, self_mask=causal, train=train,
                                                  rngs=rngs)
        return self.head(self.ln_f(x))
