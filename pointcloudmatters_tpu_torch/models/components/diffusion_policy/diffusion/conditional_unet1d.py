"""ConditionalUnet1D, the FiLM-conditioned temporal UNet (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/diffusion/conditional_unet1d.py``),
in PyTorch's ``(B, C, T)`` layout: the trajectory goes in and comes out as
``(B, T, C)``, as in JAX, and is transposed once at each end.

Module names are the JAX module's (``down0_res0.block0.conv``, ``mid_res1``,
``up0_us.conv``, ``final_block``, ...), so converted weights map one to one.
As there, with L down levels only L - 1 up levels run, so the first level's
skip is never consumed; and the local-condition branch's second output is
computed and never added (the reference's dead branch).

Every layer computes in the promoted type of its input and its weights, as
flax's layers do: under the trainer's ``"bf16-mixed"`` the DP policy hands
the UNet an f32 trajectory and an f32 condition (the normalizer's f32
constants promote them), so the UNet runs f32 products on bf16-rounded
weights, as the JAX step does. ``F.linear`` and ``F.conv1d`` would refuse
the mixed operands; the layers below cast them first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "mish",
    "SinusoidalPosEmb",
    "Conv1dBlock",
    "Downsample1d",
    "Upsample1d",
    "ConditionalResidualBlock1D",
    "ConditionalUnet1D",
]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _promoted(x: torch.Tensor, *params: Optional[torch.Tensor]) -> torch.dtype:
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in the promoted type of input and weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promoted(x, self.weight, self.bias)
        return F.linear(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in the promoted type of input and weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promoted(x, self.weight, self.bias)
        return F.conv1d(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype),
                        self.stride, self.padding)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` in the promoted type of input and weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promoted(x, self.weight, self.bias)
        return F.conv_transpose1d(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype),
                                  self.stride, self.padding)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in the promoted type of input and weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _promoted(x, self.weight, self.bias)
        return F.group_norm(x.to(dtype), self.num_groups, self.weight.to(dtype),
                            self.bias.to(dtype), self.eps)


class SinusoidalPosEmb(nn.Module):
    """(B,) timesteps -> (B, dim) [sin | cos] halves, in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = x.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class Conv1dBlock(nn.Module):
    """Conv -> GroupNorm (eps 1e-5, torch's) -> Mish, (B, C_in, T) -> (B, C, T)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, n_groups: int = 8):
        super().__init__()
        self.conv = Conv1d(in_channels, features, kernel_size, padding=kernel_size // 2)
        self.norm = GroupNorm(n_groups, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(self.norm(self.conv(x)))


class Downsample1d(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv = Conv1d(features, features, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1d(nn.Module):
    """An exact 2x upsample: ``ConvTranspose1d(k=4, s=2, p=1)``, which is
    flax's ``ConvTranspose(4, 2, "SAME")`` with its kernel flipped in time
    (``utils/flax_to_torch.py``)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = ConvTranspose1d(features, features, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConditionalResidualBlock1D(nn.Module):
    """Two conv blocks with FiLM conditioning between them (a scale and a
    bias a channel with ``cond_predict_scale``, else a bias) and a 1x1
    convolution on the residual where the widths differ."""

    def __init__(self, in_channels: int, features: int, cond_dim: int, kernel_size: int = 3,
                 n_groups: int = 8, cond_predict_scale: bool = False):
        super().__init__()
        self.features = features
        self.cond_predict_scale = cond_predict_scale
        self.block0 = Conv1dBlock(in_channels, features, kernel_size, n_groups)
        self.cond_encoder = Linear(cond_dim, features * (2 if cond_predict_scale else 1))
        self.block1 = Conv1dBlock(features, features, kernel_size, n_groups)
        if in_channels != features:
            self.residual_conv = Conv1d(in_channels, features, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        out = self.block0(x)
        embed = self.cond_encoder(mish(cond))[:, :, None]  # (B, C or 2C, 1)
        if self.cond_predict_scale:
            out = embed[:, :self.features] * out + embed[:, self.features:]
        else:
            out = out + embed
        out = self.block1(out)
        if hasattr(self, "residual_conv"):
            x = self.residual_conv(x)
        return out + x


class ConditionalUnet1D(nn.Module):
    """(B, T, input_dim) trajectory + timesteps + (B, G) global condition ->
    (B, T, input_dim). ``global_cond_dim`` is G, the condition's width
    (the JAX module infers it at its first call)."""

    def __init__(self, input_dim: int, local_cond_dim: Optional[int] = None,
                 global_cond_dim: Optional[int] = None, diffusion_step_embed_dim: int = 256,
                 down_dims: Sequence[int] = (256, 512, 1024), kernel_size: int = 3,
                 n_groups: int = 8, cond_predict_scale: bool = False):
        super().__init__()
        down_dims = list(down_dims)
        all_dims = [input_dim] + down_dims
        in_out = list(zip(all_dims[:-1], all_dims[1:]))
        dsed = diffusion_step_embed_dim
        self.input_dim = input_dim
        self.down_dims = down_dims
        self.n_levels = len(in_out)
        cond_dim = dsed + (global_cond_dim or 0)

        def res(c_in, features):
            return ConditionalResidualBlock1D(c_in, features, cond_dim, kernel_size, n_groups,
                                              cond_predict_scale)

        self.pos_emb = SinusoidalPosEmb(dsed)
        self.time_mlp1 = Linear(dsed, dsed * 4)
        self.time_mlp2 = Linear(dsed * 4, dsed)
        self.has_local_cond = local_cond_dim is not None
        if self.has_local_cond:
            self.local_down = res(local_cond_dim, in_out[0][1])
            self.local_up = res(local_cond_dim, in_out[0][1])
        for idx, (dim_in, dim_out) in enumerate(in_out):
            setattr(self, f"down{idx}_res0", res(dim_in, dim_out))
            setattr(self, f"down{idx}_res1", res(dim_out, dim_out))
            if idx < len(in_out) - 1:
                setattr(self, f"down{idx}_ds", Downsample1d(dim_out))
        self.mid_res0 = res(all_dims[-1], all_dims[-1])
        self.mid_res1 = res(all_dims[-1], all_dims[-1])
        for idx, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
            setattr(self, f"up{idx}_res0", res(dim_out * 2, dim_in))
            setattr(self, f"up{idx}_res1", res(dim_in, dim_in))
            setattr(self, f"up{idx}_us", Upsample1d(dim_in))
        self.final_block = Conv1dBlock(down_dims[0], down_dims[0], kernel_size, n_groups)
        self.final_conv = Conv1d(down_dims[0], input_dim, 1)

    def forward(self, sample: torch.Tensor, timestep, local_cond: Optional[torch.Tensor] = None,
                global_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = sample.shape[0]
        if isinstance(timestep, torch.Tensor):
            timesteps = timestep.reshape(-1).expand(B) if timestep.numel() == 1 else timestep
        else:  # a host integer, filled on the device (no copy)
            timesteps = torch.full((B,), timestep, dtype=torch.int32, device=sample.device)
        # the sinusoids in f32, then the trajectory's type, as in JAX
        t_emb = self.pos_emb(timesteps).to(sample.dtype)
        t_emb = self.time_mlp2(mish(self.time_mlp1(t_emb)))
        global_feature = t_emb
        if global_cond is not None:
            global_feature = torch.cat([t_emb, global_cond], dim=-1)

        h_local = []
        if local_cond is not None:
            local_cond = local_cond.transpose(1, 2)
            h_local.append(self.local_down(local_cond, global_feature))
            h_local.append(self.local_up(local_cond, global_feature))  # never added

        x = sample.transpose(1, 2)  # (B, C, T)
        h = []
        for idx in range(self.n_levels):
            x = getattr(self, f"down{idx}_res0")(x, global_feature)
            if idx == 0 and h_local:
                x = x + h_local[0]
            x = getattr(self, f"down{idx}_res1")(x, global_feature)
            h.append(x)
            if idx < self.n_levels - 1:
                x = getattr(self, f"down{idx}_ds")(x)
        x = self.mid_res0(x, global_feature)
        x = self.mid_res1(x, global_feature)
        for idx in range(self.n_levels - 1):
            x = torch.cat([x, h.pop()], dim=1)
            x = getattr(self, f"up{idx}_res0")(x, global_feature)
            x = getattr(self, f"up{idx}_res1")(x, global_feature)
            x = getattr(self, f"up{idx}_us")(x)
        x = self.final_conv(self.final_block(x))
        return x.transpose(1, 2)
