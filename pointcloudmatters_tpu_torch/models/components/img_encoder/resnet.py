"""ResNet image encoders over channel-last images (port of
``pointcloudmatters_tpu/models/components/img_encoder/resnet.py``).

torchvision's ResNet-18/34/50 topology (v1.5: the bottleneck strides on its
3x3) as the JAX module builds it: images ``(B, H, W, C)`` with float RGB in
[0, 1] (and raw depth or coordinates past it) are resized to ``resize_to``
(bilinear, as ``jax.image.resize``: ``utils/image.py``), normalised per
channel (``_NORM_STATS`` of ``channels`` 1, 3, 4 or 6), then run through the
stem and four stages to ``(B, h, w, C)`` features, or ``(B, C)`` with
``avg_pool``.

Activations stay channel-last: each convolution sees the NCHW view of an
NHWC tensor, which is torch's ``channels_last`` layout, so no copy is made
between layers; weights are torch's own (O, I, kh, kw). The batch norms are
the port's ``MaskedBatchNorm`` over the last axis (the running variance
unbiased, the statistics global under data parallelism). Names are the
JAX module's (``conv1``, ``bn1``, ``layer<s>_<b>`` with ``conv<i>``,
``bn<i>``, ``downsample_conv``, ``downsample_bn``), so converted JAX
variables map one to one.

:func:`load_torch_state_dict` copies a torchvision or R3M state dict in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.nn_utils import MaskedBatchNorm
from pointcloudmatters_tpu_torch.utils.image import resize

__all__ = ["BasicBlock", "Bottleneck", "ResNetTorchVision", "R3MResNet",
           "load_torch_state_dict", "resnet_state_dict", "inflate_conv1", "conv_nhwc",
           "NORM_STATS"]

NORM_STATS = {
    1: ([0.5], [0.5]),
    3: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    4: ([0.485, 0.456, 0.406, 0.5], [0.229, 0.224, 0.225, 0.5]),
    6: ([0.485, 0.456, 0.406, 0.5, 0.5, 0.5], [0.229, 0.224, 0.225, 0.5, 0.5, 0.5]),
}

_STAGES = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride, padding=kernel // 2, bias=False)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over a channel-last ``(B, H, W, C)`` tensor, channel-last out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def register_norm_stats(module: nn.Module, channels: int) -> None:
    """The per-channel ``_norm_mean`` / ``_norm_std`` of ``channels`` as f64
    buffers outside the state dict (they follow the module to its device)."""
    if channels not in NORM_STATS:
        raise ValueError(f"channels {channels}: one of {sorted(NORM_STATS)}")
    mean, std = NORM_STATS[channels]
    module.register_buffer("_norm_mean", torch.tensor(mean, dtype=torch.float64),
                           persistent=False)
    module.register_buffer("_norm_std", torch.tensor(std, dtype=torch.float64),
                           persistent=False)


def normalize(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / std`` in x's type, the constants rounded once to it,
    as the JAX modules normalise."""
    return (x - module._norm_mean.to(x.dtype)) / module._norm_std.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False,
                 group=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, stride)
        self.bn1 = MaskedBatchNorm(features, group=group)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = MaskedBatchNorm(features, group=group)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(c_in, features, 1, stride)
            self.downsample_bn = MaskedBatchNorm(features, group=group)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        ra = not train
        out = F.relu(self.bn1(conv_nhwc(self.conv1, x), use_running_average=ra))
        out = self.bn2(conv_nhwc(self.conv2, out), use_running_average=ra)
        if self.downsample:
            x = self.downsample_bn(conv_nhwc(self.downsample_conv, x), use_running_average=ra)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    """Output width ``4 * features``; the stride on the 3x3 (v1.5)."""

    expansion = 4

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False,
                 group=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 1)
        self.bn1 = MaskedBatchNorm(features, group=group)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = MaskedBatchNorm(features, group=group)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = MaskedBatchNorm(features * 4, group=group)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(c_in, features * 4, 1, stride)
            self.downsample_bn = MaskedBatchNorm(features * 4, group=group)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        ra = not train
        out = F.relu(self.bn1(conv_nhwc(self.conv1, x), use_running_average=ra))
        out = F.relu(self.bn2(conv_nhwc(self.conv2, out), use_running_average=ra))
        out = self.bn3(conv_nhwc(self.conv3, out), use_running_average=ra)
        if self.downsample:
            x = self.downsample_bn(conv_nhwc(self.downsample_conv, x), use_running_average=ra)
        return F.relu(out + x)


class ResNetTorchVision(nn.Module):
    """``forward(images (B, H, W, channels), train) -> (B, h, w, C)`` or
    ``(B, C)`` with ``avg_pool``; ``num_channels`` is C (512 or 2048).

    ``pretrained`` is the configs' flag, not read, as in JAX: weights come
    from ``pretrained_path`` (a local file, copied in by
    ``models/components/pretrained.py``)."""

    def __init__(self, resnet_model: str = "resnet50", pretrained: bool = False,
                 pretrained_path: Optional[str] = None, channels: int = 3,
                 avg_pool: bool = False, resize_to: int = 224, group=None):
        super().__init__()
        if resnet_model not in _STAGES:
            raise NotImplementedError(resnet_model)
        self.resnet_model = resnet_model
        self.pretrained = pretrained
        self.pretrained_path = pretrained_path
        self.channels = channels
        self.avg_pool = avg_pool
        self.resize_to = resize_to
        register_norm_stats(self, channels)
        kind, stage_sizes = _STAGES[resnet_model]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = MaskedBatchNorm(64, group=group)
        self.block_names = []
        c_in = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                down = b == 0 and (stride != 1 or stage == 0 and kind == "bottleneck")
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(c_in, features, stride, down, group))
                self.block_names.append(name)
                c_in = features * block.expansion
        self._num_channels = c_in

    @property
    def num_channels(self) -> int:
        return self._num_channels

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.shape[-3] != self.resize_to or x.shape[-2] != self.resize_to:
            x = resize(x, (self.resize_to, self.resize_to), "bilinear")
        x = normalize(self, x)
        x = F.relu(self.bn1(conv_nhwc(self.conv1, x), use_running_average=not train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)  # -inf padding
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        return x.mean(dim=(-3, -2)) if self.avg_pool else x


class R3MResNet(ResNetTorchVision):
    """The R3M-pretrained variant: R3M's weights from ``pretrained_path``."""


def inflate_conv1(w: torch.Tensor, channels: int) -> torch.Tensor:
    """A 3-channel stem or patch kernel widened to ``channels``: the RGB
    kernels copied, the extra channels zero; at one channel the whole
    kernel is zero (the reference's quirk, kept in JAX ``resnet.py:168-179``
    and ``vit.py:216-226``)."""
    out = w.new_zeros((w.shape[0], channels) + tuple(w.shape[2:]))
    if channels != 1:
        out[:, :3] = w[:, :3]
    return out


def resnet_state_dict(module: ResNetTorchVision, state_dict: dict) -> dict:
    """``module``'s state dict from a torchvision or R3M one: the
    ``module.``, ``convnet.`` and ``resnet.`` prefixes stripped, ``fc`` and
    the batch counters left out, a batch norm's ``weight`` / ``running_mean``
    / ``running_var`` as ``scale`` / ``mean`` / ``var``, ``downsample.0`` /
    ``.1`` as ``downsample_conv`` / ``downsample_bn``, the stem inflated to
    the module's channels (:func:`inflate_conv1`)."""
    sd = {k.replace("module.", "").replace("convnet.", "").replace("resnet.", ""):
          torch.as_tensor(v) for k, v in state_dict.items()}
    out = {}

    def put_bn(name: str, prefix: str) -> None:
        out[f"{name}.scale"] = sd[f"{prefix}.weight"]
        out[f"{name}.bias"] = sd[f"{prefix}.bias"]
        out[f"{name}.mean"] = sd[f"{prefix}.running_mean"]
        out[f"{name}.var"] = sd[f"{prefix}.running_var"]

    conv1 = sd["conv1.weight"]
    out["conv1.weight"] = (conv1 if conv1.shape[1] == module.channels
                           else inflate_conv1(conv1, module.channels))
    put_bn("bn1", "bn1")
    for name in module.block_names:
        stage, b = name[len("layer"):].split("_")
        prefix, block = f"layer{stage}.{b}", getattr(module, name)
        for i in (1, 2, 3):
            if hasattr(block, f"conv{i}"):
                out[f"{name}.conv{i}.weight"] = sd[f"{prefix}.conv{i}.weight"]
                put_bn(f"{name}.bn{i}", f"{prefix}.bn{i}")
        if block.downsample:
            out[f"{name}.downsample_conv.weight"] = sd[f"{prefix}.downsample.0.weight"]
            put_bn(f"{name}.downsample_bn", f"{prefix}.downsample.1")
    return out


def load_torch_state_dict(module: ResNetTorchVision, state_dict: dict) -> None:
    """Copy a torchvision or R3M state dict into ``module``
    (:func:`resnet_state_dict`); every entry of the module must be found."""
    module.load_state_dict(resnet_state_dict(module, state_dict), strict=True)
