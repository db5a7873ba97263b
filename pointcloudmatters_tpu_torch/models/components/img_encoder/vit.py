"""ViT image encoders over channel-last images (port of
``pointcloudmatters_tpu/models/components/img_encoder/vit.py``).

- ``VisionTransformer``: a patch convolution, a learned ``pos_embed`` that
  starts from the fixed 2-D sincos table (:func:`get_2d_sincos_pos_embed`,
  the CLS row zero), a ``cls_token``, pre-norm blocks (flax ``LayerNorm``'s
  eps 1e-6, dense attention with flax's projection layout, exact GELU), and
  one of three outputs: ``use_cls_token`` (B, D), the normed CLS token;
  ``global_pool`` (B, D), the patch tokens' mean through ``fc_norm``;
  ``reshape_embedding`` (B, g, g, D), the normed patch tokens. With
  ``mask_ratio`` and ``train`` it keeps a random subset of the patch tokens
  (MAE's masking), drawn from the ``generator`` passed in.
- ``ViT``: resize to 256/224 of ``img_size`` (bicubic, as
  ``jax.image.resize``: ``utils/image.py``), centre-crop ``img_size``,
  normalise per channel, then the transformer (``model``); ``MAEViT``
  masks 75% in training, ``VC1ViT`` takes VC-1's weights from
  ``pretrained_path``.
- :func:`load_torch_vit_state_dict` copies a timm / MAE / VC-1 state dict in.

Names are the JAX module's (``patch_embed_proj``, ``blocks_<i>`` with
``norm1``, ``attn.{query,key,value,out}``, ``norm2``, ``mlp_fc1``,
``mlp_fc2``; ``norm``, ``fc_norm``), so converted JAX variables map one to
one. The attention is plain torch: JAX computes it in XLA, not in a Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.act.transformer import MultiHeadAttention
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import (
    conv_nhwc,
    inflate_conv1,
    normalize,
    register_norm_stats,
)
from pointcloudmatters_tpu_torch.utils.image import resize

__all__ = ["get_2d_sincos_pos_embed", "Block", "VisionTransformer", "ViT", "MAEViT",
           "VC1ViT", "load_torch_vit_state_dict", "vit_state_dict", "centre_crop_resize",
           "ARCHS"]

ARCHS = {
    "vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16),
    "mae_vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12),
    "mae_vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16),
}


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """(grid^2 [+ 1], D) f32 sincos table: for each cell the row's
    ``D / 2`` features (sines then cosines of ``D / 4`` frequencies), then
    the column's; a zero row first with ``cls_token``."""
    def embed_1d(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (embed_dim // 4))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_w, grid_h = np.meshgrid(np.arange(grid_size, dtype=np.float32),
                                 np.arange(grid_size, dtype=np.float32))
    emb = np.concatenate([embed_1d(grid_h), embed_1d(grid_w)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def centre_crop_resize(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """Resize(256 * img_size / 224, bicubic) then CenterCrop(img_size) of
    square channel-last images, unless they are ``img_size`` already."""
    if x.shape[-3] == img_size and x.shape[-2] == img_size:
        return x
    short = 256 * img_size // 224
    x = resize(x, (short, short), "bicubic")
    top = (short - img_size) // 2
    return x[..., top:top + img_size, top:top + img_size, :]


class Block(nn.Module):
    """Pre-norm transformer block (JAX ``vit.py:70-89`` ``_Block``)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(embed_dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.attn = MultiHeadAttention(embed_dim, num_heads, 0.0, "dense")
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(embed_dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.attn(y, y, y)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


def draw_trunc_normal(p: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """flax's ``truncated_normal(std)``: normal, cut at two std."""
    nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)


def mask_noise(shape: tuple, generator: torch.Generator, device) -> torch.Tensor:
    """MAE masking's uniform noise, one value a token."""
    return torch.rand(shape, generator=generator, device=device)


class VisionTransformer(nn.Module):
    """(B, H, W, C) -> the ``classifier_feature`` output (module doc)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, channels: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, classifier_feature: str = "use_cls_token",
                 mask_ratio: Optional[float] = None):
        super().__init__()
        if classifier_feature not in ("use_cls_token", "global_pool", "reshape_embedding"):
            raise NotImplementedError(classifier_feature)
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.depth = depth
        self.classifier_feature = classifier_feature
        self.mask_ratio = mask_ratio
        self.patch_embed_proj = nn.Conv2d(channels, embed_dim, patch_size, patch_size)
        self.pos_embed = nn.Parameter(torch.tensor(  # on the default device (meta too)
            get_2d_sincos_pos_embed(embed_dim, self.grid_size, cls_token=True)[None]))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", Block(embed_dim, num_heads, mlp_ratio))
        if classifier_feature == "global_pool":
            self.fc_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        else:
            self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        """``pos_embed`` the sincos table, ``cls_token`` flax's
        ``truncated_normal(0.02)`` (the JAX module's initialisers)."""
        self.pos_embed.copy_(torch.from_numpy(
            get_2d_sincos_pos_embed(self.embed_dim, self.grid_size, cls_token=True)[None]))
        draw_trunc_normal(self.cls_token, generator)

    @staticmethod
    def random_masking(x: torch.Tensor, mask_ratio: float,
                       generator: torch.Generator) -> torch.Tensor:
        """Keep a random ``1 - mask_ratio`` of each row's tokens, in the
        order of uniform noise drawn from ``generator`` (:func:`mask_noise`)."""
        N, L, D = x.shape
        len_keep = int(L * (1 - mask_ratio))
        noise = mask_noise((N, L), generator, x.device)
        keep = torch.argsort(noise, dim=1)[:, :len_keep]
        return torch.gather(x, 1, keep[..., None].expand(N, len_keep, D))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = x.shape[0]
        x = conv_nhwc(self.patch_embed_proj, x)
        x = x.reshape(B, -1, self.embed_dim) + self.pos_embed[:, 1:, :]
        if self.mask_ratio is not None and train:
            if generator is None:
                raise ValueError("MAE masking in training needs a generator")
            x = self.random_masking(x, self.mask_ratio, generator)
        cls = (self.cls_token + self.pos_embed[:, :1, :]).expand(B, 1, self.embed_dim)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        if self.classifier_feature == "global_pool":
            return self.fc_norm(x[:, 1:, :].mean(dim=1))
        x = self.norm(x)
        if self.classifier_feature == "use_cls_token":
            return x[:, 0]
        tokens = x[:, 1:, :]
        g = int(round(tokens.shape[1] ** 0.5))
        return tokens.reshape(B, g, g, self.embed_dim)


class ViT(nn.Module):
    """The reference's ViT wrapper (JAX ``vit.py:170-209``): preprocessing,
    then ``model``; ``num_channels`` is the width."""

    default_model = "vit_base_patch16"
    default_mask_ratio: Optional[float] = None

    def __init__(self, model_name: Optional[str] = None, channels: int = 3,
                 pretrained_path: Optional[str] = None, feature_mode: str = "use_cls_token",
                 mask_ratio: Optional[float] = None, img_size: int = 224):
        super().__init__()
        self.model_name = model_name or self.default_model
        self.channels = channels
        self.pretrained_path = pretrained_path
        self.img_size = img_size
        register_norm_stats(self, channels)
        self.model = VisionTransformer(
            img_size=img_size, channels=channels, classifier_feature=feature_mode,
            mask_ratio=self.default_mask_ratio if mask_ratio is None else mask_ratio,
            **ARCHS[self.model_name])

    @property
    def num_channels(self) -> int:
        return self.model.embed_dim

    @property
    def masks_tokens(self) -> bool:
        """Whether training masks patch tokens (and so takes a generator)."""
        return self.model.mask_ratio is not None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = normalize(self, centre_crop_resize(x, self.img_size))
        return self.model(x, train=train, generator=generator)


class MAEViT(ViT):
    """MAE's variant: 75% of the patch tokens masked in training."""

    default_model = "mae_vit_base_patch16"
    default_mask_ratio = 0.75


class VC1ViT(ViT):
    """VC-1's variant: its weights from ``pretrained_path``."""


def put_blocks(out: dict, sd: dict, prefix: str, source: str, n: int) -> None:
    """The entries of ``n`` pre-norm blocks ``{prefix}_<i>`` from a timm-style
    ``{source}.<i>``: ``attn.qkv`` split into ``query`` / ``key`` /
    ``value`` (a missing qkv bias zero), ``attn.proj`` as ``out``,
    ``mlp.fc1`` / ``fc2`` as ``mlp_fc1`` / ``mlp_fc2``."""
    for i in range(n):
        dst, src = f"{prefix}_{i}", f"{source}.{i}"
        for ln in ("norm1", "norm2"):
            out[f"{dst}.{ln}.weight"] = sd[f"{src}.{ln}.weight"]
            out[f"{dst}.{ln}.bias"] = sd[f"{src}.{ln}.bias"]
        qkv_w = sd[f"{src}.attn.qkv.weight"]
        D = qkv_w.shape[1]
        qkv_b = sd.get(f"{src}.attn.qkv.bias", qkv_w.new_zeros(3 * D))
        for j, proj in enumerate(("query", "key", "value")):
            out[f"{dst}.attn.{proj}.weight"] = qkv_w[j * D:(j + 1) * D]
            out[f"{dst}.attn.{proj}.bias"] = qkv_b[j * D:(j + 1) * D]
        out[f"{dst}.attn.out.weight"] = sd[f"{src}.attn.proj.weight"]
        out[f"{dst}.attn.out.bias"] = sd[f"{src}.attn.proj.bias"]
        for fc in ("fc1", "fc2"):
            out[f"{dst}.mlp_{fc}.weight"] = sd[f"{src}.mlp.{fc}.weight"]
            out[f"{dst}.mlp_{fc}.bias"] = sd[f"{src}.mlp.{fc}.bias"]


def vit_state_dict(module: ViT, state_dict: dict) -> dict:
    """``module``'s state dict from a timm / MAE / VC-1 one (the decoder and
    ``mask_token`` left out, the ``module.`` prefix stripped, the patch
    kernel inflated to the module's channels); the port's linears take
    torch's (out, in) as it is. A ``norm`` / ``fc_norm`` the file lacks
    keeps the module's, as in JAX."""
    sd = {k.replace("module.", ""): torch.as_tensor(v) for k, v in state_dict.items()
          if "decoder" not in k and "mask_token" not in k}
    vt = module.model
    pe = sd["patch_embed.proj.weight"]
    out = dict(module.state_dict())
    out.update({"model.patch_embed_proj.weight": (
        pe if pe.shape[1] == module.channels else inflate_conv1(pe, module.channels)),
        "model.patch_embed_proj.bias": sd["patch_embed.proj.bias"],
        "model.pos_embed": sd["pos_embed"], "model.cls_token": sd["cls_token"]})
    for name in ("norm", "fc_norm"):
        if hasattr(vt, name) and f"{name}.weight" in sd:
            out[f"model.{name}.weight"] = sd[f"{name}.weight"]
            out[f"model.{name}.bias"] = sd[f"{name}.bias"]
    put_blocks(out, sd, "model.blocks", "blocks", vt.depth)
    return out


def load_torch_vit_state_dict(module: ViT, state_dict: dict) -> None:
    """Copy a timm / MAE / VC-1 state dict into ``module``
    (:func:`vit_state_dict`); every entry of the module must be found."""
    module.load_state_dict(vit_state_dict(module, state_dict), strict=True)
