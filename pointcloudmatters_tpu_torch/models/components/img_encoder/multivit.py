"""MultiViT / MultiMAE, the multi-modal image encoder, over channel-last
RGB-D images (port of
``pointcloudmatters_tpu/models/components/img_encoder/multivit.py``).

The encoder path the training configs run: a patch adapter a modality (a
patch convolution plus the fixed 2-D sincos table, cast to the tokens'
type), the modalities' tokens and ``num_global_tokens`` learned global
tokens through a shared trunk of pre-norm blocks (the ViT's ``Block``);
``MultiViTModel`` splits a 4-channel RGB-D image into RGB (ImageNet
normalised) and depth (standardised by the mean and biased variance of its
10-90% slice), after the resize to 256/224 of ``img_size`` (bicubic) and
the centre crop, and returns the last global token (B, D).

Names are the JAX module's (``input_adapters_<modality>.proj``,
``global_tokens``, ``encoder_<i>``), so converted JAX variables map one to
one. :func:`load_torch_multimae_state_dict` copies an EPFL MultiMAE state
dict in.

``ckpt_path`` is the configs' key for the MultiMAE checkpoint. The JAX
package never reads it (its pretrained loader reads only
``pretrained_path``), so ``pretrained_multimae_rgbd`` trains from random
weights there, and does here too; a warning says so.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import (
    conv_nhwc,
    normalize,
    register_norm_stats,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import (
    Block,
    centre_crop_resize,
    draw_trunc_normal,
    get_2d_sincos_pos_embed,
    put_blocks,
)
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["truncated_depth_standardize", "PatchedInputAdapter", "MultiViT",
           "MultiViTModel", "MultiMAEModel", "load_torch_multimae_state_dict",
           "multimae_state_dict"]

log = RankedLogger(__name__, rank_zero_only=True)

def truncated_depth_standardize(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) depth standardised by the mean and biased variance of
    each image's 10-90% slice of sorted values (taken in f32 and cast to the
    depth's type, as ``jnp.mean`` / ``jnp.var`` do)."""
    flat = torch.sort(depth.reshape(depth.shape[0], -1), dim=-1).values
    n = flat.shape[-1]
    trunc = flat[:, int(0.1 * n):int(0.9 * n)].float()
    mean = trunc.mean(dim=-1).to(depth.dtype)[:, None, None, None]
    var = trunc.var(dim=-1, unbiased=False).to(depth.dtype)[:, None, None, None]
    return (depth - mean) / torch.sqrt(var + 1e-6)


_POS_TABLES: dict = {}


def pos_table(dim: int, grid: int, device: torch.device) -> torch.Tensor:
    """The (grid^2, dim) sincos table on ``device``, copied there once."""
    key = (dim, grid, device)
    if key not in _POS_TABLES:
        _POS_TABLES[key] = torch.from_numpy(get_2d_sincos_pos_embed(dim, grid)).to(device)
    return _POS_TABLES[key]


class PatchedInputAdapter(nn.Module):
    """One modality's patch tokens plus the sincos table (in their type)."""

    def __init__(self, in_channels: int, patch_size: int = 16, dim_tokens: int = 768):
        super().__init__()
        self.dim_tokens = dim_tokens
        self.proj = nn.Conv2d(in_channels, dim_tokens, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(self.proj, x)
        B, h = x.shape[0], x.shape[1]
        pos = pos_table(self.dim_tokens, h, x.device).to(x.dtype)
        return x.reshape(B, -1, self.dim_tokens) + pos


class MultiViT(nn.Module):
    """The multi-modal trunk: ``forward({modality: (B, H, W, C)}, train)``
    -> (B, n_tokens + num_global_tokens, D)."""

    def __init__(self, input_modalities: Optional[dict] = None, patch_size: int = 16,
                 dim_tokens: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_global_tokens: int = 1):
        super().__init__()
        self.modalities = dict(input_modalities or {"rgb": 3, "depth": 1})
        self.dim_tokens, self.depth = dim_tokens, depth
        for name, channels in self.modalities.items():
            self.add_module(f"input_adapters_{name}",
                            PatchedInputAdapter(channels, patch_size, dim_tokens))
        self.global_tokens = nn.Parameter(torch.zeros(1, num_global_tokens, dim_tokens))
        for i in range(depth):
            self.add_module(f"encoder_{i}", Block(dim_tokens, num_heads, mlp_ratio))

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        draw_trunc_normal(self.global_tokens, generator)

    def forward(self, inputs: dict, train: bool = False) -> torch.Tensor:
        groups = [getattr(self, f"input_adapters_{name}")(inputs[name])
                  for name in self.modalities if name in inputs]
        tokens = torch.cat(groups, dim=1)
        g = self.global_tokens.expand(tokens.shape[0], -1, -1).to(tokens.dtype)
        tokens = torch.cat([tokens, g], dim=1)
        for i in range(self.depth):
            tokens = getattr(self, f"encoder_{i}")(tokens)
        return tokens


class MultiViTModel(nn.Module):
    """4-channel RGB-D -> the global token (B, dim_tokens). ``type`` is
    accepted and not read, as in JAX (the RLBench DP config passes it)."""

    def __init__(self, ckpt_path: Optional[str] = None, img_size: int = 224,
                 dim_tokens: int = 768, depth: int = 12, num_heads: int = 12,
                 type: Optional[str] = None):
        super().__init__()
        self.ckpt_path = ckpt_path
        self.img_size = img_size
        self.dim_tokens = dim_tokens
        if ckpt_path:
            log.warning(f"{self.__class__.__name__}: ckpt_path {ckpt_path} is not read "
                        "(the JAX package reads only pretrained_path); random weights")
        self.model = MultiViT(input_modalities={"rgb": 3, "depth": 1}, dim_tokens=dim_tokens,
                              depth=depth, num_heads=num_heads)
        register_norm_stats(self, 3)  # ImageNet's, for the RGB channels

    @property
    def num_channels(self) -> int:
        return self.dim_tokens

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.shape[-1] != 4:
            raise ValueError(f"expected RGBD (..., 4), got {tuple(x.shape)}")
        x = centre_crop_resize(x, self.img_size)
        rgb = normalize(self, x[..., :3])
        depth = truncated_depth_standardize(x[..., 3:])
        return self.model({"rgb": rgb, "depth": depth}, train=train)[:, -1]


class MultiMAEModel(MultiViTModel):
    """The MAE-pretrained model's encoder path (its decoders never run)."""


def multimae_state_dict(module: MultiViTModel, state_dict: dict) -> dict:
    """``module``'s state dict from an EPFL MultiMAE one (semseg and output
    adapters left out; the blocks as :func:`~.vit.put_blocks` maps them)."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if "semseg" not in k and "output_adapters" not in k}
    out = {"model.global_tokens": sd["global_tokens"]}
    for mod in ("rgb", "depth"):
        out[f"model.input_adapters_{mod}.proj.weight"] = sd[f"input_adapters.{mod}.proj.weight"]
        out[f"model.input_adapters_{mod}.proj.bias"] = sd[f"input_adapters.{mod}.proj.bias"]
    put_blocks(out, sd, "model.encoder", "encoder", module.model.depth)
    return out


def load_torch_multimae_state_dict(module: MultiViTModel, state_dict: dict) -> None:
    """Copy an EPFL MultiMAE state dict into ``module``; every entry of the
    module must be found."""
    module.load_state_dict(multimae_state_dict(module, state_dict), strict=True)
