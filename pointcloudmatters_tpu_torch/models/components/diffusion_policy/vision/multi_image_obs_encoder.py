"""Image observation encoder of the Diffusion Policy, channel-last (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/vision/multi_image_obs_encoder.py``).

The keys of ``shape_meta["obs"]`` by ``type``, each list sorted: ``rgb``
keys are encoded, ``depth`` keys are merged onto their rgb key
(``key.replace("rgb", "depth")``, when the batch has it and it is a depth
key) with ``use_depth`` or ``only_depth`` (``only_depth``: the depth alone
goes through), and ``low_dim`` keys are appended raw after the image
features. Each image is resized (bilinear, as ``jax.image.resize``:
``utils/image.py``) to ``resize_shape``, cropped to ``crop_shape`` (one
random crop a row in training with ``random_crop``, drawn from
``rngs["crop"]``; else the centre crop), and ImageNet-normalised on its
first three channels with ``imagenet_norm``.

With ``share_rgb_model`` one ``rgb_model`` encodes every key's images,
stacked along the batch, and must pool each image to (B, D)
(:func:`pooled_width`; JAX's ``ValueError``, raised here at construction);
otherwise each rgb key has its own copy, ``model_<key>``, drawn on its own,
and its features are flattened to (B, -1) whatever their shape (ResNet
without ``avg_pool`` gives (B, h, w, C), ViT's ``reshape_embedding`` (B,
g, g, D)); as in JAX, where the copies are not module fields, no
pretrained weights reach them: their ``pretrained_path`` is cleared, with
one warning. ``use_group_norm`` is accepted and not read, as in JAX.

:attr:`MultiImageObsEncoder.feature_dim` is the width of one frame's
features, which the policy needs before its UNet is built (JAX infers it at
``init``): the sum over the rgb keys of :attr:`key_widths`, a pooling
model's ``num_channels``, or for an unpooled per-key model the flattened
width of its output at the image shape the encoder feeds that key
(:func:`unpooled_width`), plus the low-dim keys' widths.

Under ``"bf16-mixed"`` the normalizer's f32 constants make the images f32,
and flax's layers promote their bf16 weights to the input's type: the
backbone then runs in f32 on bf16-rounded weights. :func:`run_promoted`
calls a backbone so.
"""

from __future__ import annotations

import copy
import itertools
import math
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.crop_randomizer import (  # noqa: E501
    crop_image_from_indices,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import ResNetTorchVision
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import ViT
from pointcloudmatters_tpu_torch.utils.image import resize
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["MultiImageObsEncoder", "center_crop", "random_crop", "crop_offsets",
           "pools", "pooled_width", "unpooled_width", "run_promoted"]

log = RankedLogger(__name__, rank_zero_only=True)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The (h, w) window of ``(..., H, W, C)`` at ``((H - h) // 2, (W - w) // 2)``."""
    H, W = x.shape[-3], x.shape[-2]
    top, left = (H - h) // 2, (W - w) // 2
    return x[..., top:top + h, left:left + w, :]


def crop_offsets(generator: torch.Generator, batch: int, H: int, W: int, h: int, w: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (top, left) a row, uniform in [0, H - h] x [0, W - w] (both ends
    drawn), on the generator's device."""
    dev = generator.device
    tops = torch.randint(0, H - h + 1, (batch,), generator=generator, device=dev)
    lefts = torch.randint(0, W - w + 1, (batch,), generator=generator, device=dev)
    return tops, lefts


def random_crop(x: torch.Tensor, h: int, w: int, generator: torch.Generator) -> torch.Tensor:
    """One random (h, w) crop a row of ``(B, H, W, C)`` (:func:`crop_offsets`)."""
    tops, lefts = crop_offsets(generator, x.shape[0], x.shape[-3], x.shape[-2], h, w)
    return crop_image_from_indices(x, torch.stack([tops, lefts], dim=-1)[:, None], h, w)[:, 0]


def pools(model: nn.Module) -> bool:
    """Whether ``model`` gives one (D,) vector an image: not a ResNet
    without ``avg_pool``, nor a ViT with ``reshape_embedding``."""
    return not (isinstance(model, ResNetTorchVision) and not model.avg_pool
                or isinstance(model, ViT) and model.model.classifier_feature == "reshape_embedding")


def pooled_width(model: nn.Module) -> int:
    """The width of one image's features from a model that pools: its
    ``num_channels`` (ResNet's 2048 or 512 with ``avg_pool``, the ViTs' and
    MultiViT's token width). A model that does not pool raises JAX's
    ``ValueError`` (a shared model must pool)."""
    if not pools(model):
        raise ValueError("shared rgb_model must pool to (B, D); set avg_pool=True")
    return model.num_channels


def unpooled_width(model: nn.Module, shape: Sequence[int]) -> int:
    """The flattened width of ``model``'s output for one (H, W, C) image of
    ``shape``: a forward in eval mode on meta copies of its parameters and
    buffers, or, where a layer cannot run on the meta device, a batch-1
    forward on CPU copies under ``torch.no_grad()``. Either way the model's
    own tensors (batch-norm running statistics too) are not touched and no
    generator is drawn from."""
    tensors = dict(itertools.chain(model.named_parameters(), model.named_buffers()))
    try:
        out = torch.func.functional_call(
            model, {n: torch.empty_like(t, device="meta") for n, t in tensors.items()},
            (torch.empty((1, *shape), device="meta"),), {"train": False})
    except (NotImplementedError, RuntimeError):
        with torch.no_grad():
            out = torch.func.functional_call(
                model, {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()},
                (torch.zeros((1, *shape), device="cpu"),), {"train": False})
    return math.prod(out.shape[1:])


def run_promoted(model: nn.Module, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """``model(x, **kwargs)`` in the promoted type of ``x`` and the model's
    parameters, as flax's layers compute: an f32 image through bf16
    parameters runs in f32 on them, through differentiable casts."""
    params = dict(model.named_parameters())
    dtype = next(iter(params.values())).dtype
    promoted = torch.promote_types(x.dtype, dtype)
    x = x.to(promoted)
    if promoted == dtype:
        return model(x, **kwargs)
    return torch.func.functional_call(
        model, {n: p.to(promoted) if p.is_floating_point() else p for n, p in params.items()},
        (x,), kwargs)


class MultiImageObsEncoder(nn.Module):
    """``forward(obs_dict, train, rngs)`` -> (B, :attr:`feature_dim`): the
    rgb keys' features (the key axis after the batch), then the low-dim
    keys, in sorted key order (module doc)."""

    def __init__(self, shape_meta: Any, rgb_model: nn.Module,
                 resize_shape: Optional[Sequence[int]] = None,
                 crop_shape: Optional[Sequence[int]] = None, random_crop: bool = True,
                 use_group_norm: bool = False, share_rgb_model: bool = False,
                 imagenet_norm: bool = False, use_depth: bool = False, only_depth: bool = False):
        super().__init__()
        self.shape_meta = shape_meta
        self.resize_shape = None if resize_shape is None else tuple(resize_shape)
        self.crop_shape = None if crop_shape is None else tuple(crop_shape)
        self.random_crop = random_crop
        self.use_group_norm = use_group_norm  # not read, as in JAX
        self.share_rgb_model = share_rgb_model
        self.imagenet_norm = imagenet_norm
        self.use_depth = use_depth
        self.only_depth = only_depth
        meta = shape_meta["obs"]

        def keys(kind: str) -> list[str]:
            return sorted(k for k, a in meta.items() if a.get("type", "low_dim") == kind)

        self.rgb_keys, self.depth_keys, self.low_dim_keys = (
            keys("rgb"), keys("depth"), keys("low_dim"))
        self.low_dim_width = sum(math.prod(meta[k]["shape"]) for k in self.low_dim_keys)
        if share_rgb_model and self.rgb_keys or pools(rgb_model):
            self.key_widths = dict.fromkeys(self.rgb_keys, pooled_width(rgb_model))
        else:  # each key's map at the shape the encoder feeds that key's copy
            self.key_widths = {k: unpooled_width(rgb_model, self._model_input_shape(k))
                               for k in self.rgb_keys}
        if share_rgb_model:
            self.rgb_model = rgb_model
        else:  # an independent copy a key; the template itself is not kept
            unread = []
            for key in self.rgb_keys:
                model = copy.deepcopy(rgb_model)
                for name, m in model.named_modules():
                    if getattr(m, "pretrained_path", None):
                        m.pretrained_path = None
                        unread.append(f"model_{key}.{name}".rstrip("."))
                self.add_module(f"model_{key}", model)
            if unread:
                log.warning(f"pretrained_path of the per-key image models {unread} not read, "
                            "as in JAX (share_rgb_model false: they are not module fields); "
                            "random init")
        self.register_buffer("_mean", torch.tensor(_IMAGENET_MEAN, dtype=torch.float64),
                             persistent=False)
        self.register_buffer("_std", torch.tensor(_IMAGENET_STD, dtype=torch.float64),
                             persistent=False)

    @property
    def feature_dim(self) -> int:
        """Features an observation frame: every rgb key's and the low-dim keys'."""
        return sum(self.key_widths.values()) + self.low_dim_width

    def key_models(self) -> dict[str, nn.Module]:
        """The per-key copies by rgb key (none with a shared model)."""
        return {} if self.share_rgb_model else {
            k: getattr(self, f"model_{k}") for k in self.rgb_keys}

    def _model_input_shape(self, key: str) -> tuple[int, int, int]:
        """The (H, W, C) image the encoder feeds the model for ``key``: the
        obs shape of ``shape_meta`` (channel-last, or channel-first as the
        RLBench configs write it), with its depth key's channels merged
        (alone with ``only_depth``), resized and cropped."""
        meta = self.shape_meta["obs"]

        def hwc(k: str) -> tuple:
            s = tuple(int(d) for d in meta[k]["shape"])
            return s if s[-1] <= s[0] else s[1:] + s[:1]

        h, w, c = hwc(key)
        depth_key = key.replace("rgb", "depth")
        if (self.use_depth or self.only_depth) and depth_key in self.depth_keys:
            c = hwc(depth_key)[-1] + (0 if self.only_depth else c)
        h, w = self.crop_shape or self.resize_shape or (h, w)
        return h, w, c

    def _transform(self, img: torch.Tensor, train: bool,
                   rngs: Optional[Mapping]) -> torch.Tensor:
        if self.resize_shape is not None:
            img = resize(img, self.resize_shape, "bilinear")
        if self.crop_shape is not None:
            h, w = self.crop_shape
            if self.random_crop and train:
                if rngs is None or "crop" not in rngs:
                    raise ValueError("random crops in training need rngs['crop']")
                img = random_crop(img, h, w, rngs["crop"])
            else:
                img = center_crop(img, h, w)
        if self.imagenet_norm:
            rgb = (img[..., :3] - self._mean.to(img.dtype)) / self._std.to(img.dtype)
            img = torch.cat([rgb, img[..., 3:]], dim=-1) if img.shape[-1] > 3 else rgb
        return img

    def _merge_depth(self, key: str, img: torch.Tensor, obs_dict: dict) -> torch.Tensor:
        depth_key = key.replace("rgb", "depth")
        if (self.use_depth or self.only_depth) and depth_key in obs_dict \
                and depth_key in self.depth_keys:
            depth = obs_dict[depth_key]
            return depth if self.only_depth else torch.cat([img, depth], dim=-1)
        return img

    def forward(self, obs_dict: dict, train: bool = False,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        features = []
        batch_size: Optional[int] = None
        if self.share_rgb_model and self.rgb_keys:
            imgs = []
            for key in self.rgb_keys:
                img = self._merge_depth(key, obs_dict[key], obs_dict)
                imgs.append(self._transform(img, train, rngs))
                batch_size = img.shape[0]
            feat = run_promoted(self.rgb_model, torch.cat(imgs, dim=0), train=train)
            feat = feat.reshape(len(self.rgb_keys), batch_size, -1)
            features.append(feat.transpose(0, 1).reshape(batch_size, -1))
        else:
            for key, model in self.key_models().items():
                img = self._merge_depth(key, obs_dict[key], obs_dict)
                feat = run_promoted(model, self._transform(img, train, rngs), train=train)
                batch_size = feat.shape[0]
                features.append(feat.reshape(batch_size, -1))
        for key in self.low_dim_keys:
            data = obs_dict[key]
            if batch_size is not None and data.shape[0] != batch_size:
                raise ValueError(f"{key}: {tuple(data.shape)} for {batch_size} images")
            features.append(data)
        return torch.cat(features, dim=-1)
