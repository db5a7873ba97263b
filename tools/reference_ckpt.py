#!/usr/bin/env python3
"""A reference Lightning checkpoint of a port policy: the policy's tensors
under the names and layouts the reference's modules give them, as
``scripts/port_reference_ckpt.py`` and ``pointcloudmatters_tpu_torch.port_reference_ckpt``
read them (the inverse of the latter). For tests and ``chip_smoke.py``
phase 16 (f), which have no reference-trained checkpoint; imports torch and
the port, nothing of JAX::

    from tools.reference_ckpt import reference_state_dict, save_lightning_ckpt
    save_lightning_ckpt(path, reference_state_dict(policy, normalizer))

Families: ACT / ACTPCD over PointNet, SpUNet, ResNet (under a DETR
``Joiner``'s ``0.body.``, or directly with ``resnet_prefix=""``), ViT or
MultiViT; the Diffusion Policy's UNet, point-cloud encoder, image encoder
(``key_model_map``) and normalizer. Extra entries the reference also
holds (``num_batches_tracked``, metric states) are added as the reference
writes them, for the converters to skip.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from pointcloudmatters_tpu_torch.models.components.act.act import ACT
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion_unet_image_policy import (  # noqa: E501
    DiffusionUnetImagePolicy,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.multi_image_obs_encoder import (  # noqa: E501
    MultiImageObsEncoder,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.multivit import MultiViTModel
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import ResNetTorchVision
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import ViT
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import PointNet
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet import (
    SpUNet,
    to_ponderv2_state_dict,
)

__all__ = ["reference_state_dict", "save_lightning_ckpt", "backbone_state_dict"]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _bn(out: dict, dst: str, sd: dict, src: str) -> None:
    for ours, theirs in _BN.items():
        out[f"{dst}.{theirs}"] = sd[f"{src}.{ours}"]
    out[f"{dst}.num_batches_tracked"] = torch.tensor(7)


def _blocks(out: dict, sd: dict, dst: str, src: str) -> None:
    """Pre-norm ViT blocks ``{src}_<i>`` as timm's ``{dst}.<i>`` (``qkv``
    stacked, ``attn.proj``, ``mlp.fc1`` / ``fc2``)."""
    for key, v in sd.items():
        m = re.match(rf"{src}_(\d+)\.(.*)$", key)
        if not m:
            continue
        i, rest = m[1], m[2]
        q = re.match(r"attn\.(query|key|value)\.(weight|bias)$", rest)
        if q:
            if q[1] == "query":
                out[f"{dst}.{i}.attn.qkv.{q[2]}"] = torch.cat(
                    [sd[f"{src}_{i}.attn.{p}.{q[2]}"] for p in ("query", "key", "value")])
            continue
        rest = rest.replace("attn.out", "attn.proj").replace("mlp_fc", "mlp.fc")
        out[f"{dst}.{i}.{rest}"] = v


def backbone_state_dict(net: torch.nn.Module, resnet_prefix: str = "") -> dict:
    """An encoder's entries as the reference names them: PointNet's spconv
    planes and BatchNorm1d; SpUNet's PonderV2 keys; torchvision's ResNet
    (after ``resnet_prefix``); timm's ViT; EPFL's MultiMAE."""
    sd, out = _state(net), {}
    if isinstance(net, PointNet):
        for key, v in sd.items():
            mod, leaf = key.rsplit(".", 1)
            if mod.startswith("conv"):
                out[f"{mod}.0.weight"] = v.reshape(v.shape[0], 1, 1, 1, v.shape[1])
            elif mod.startswith("bn") and leaf == "scale":
                _bn(out, f"conv{mod[2:]}.1", sd, mod)
            elif mod == "final":
                out[f"final.{leaf}"] = (v.reshape(v.shape[0], 1, 1, 1, v.shape[1])
                                        if leaf == "weight" else v)
        return out
    if isinstance(net, SpUNet):
        return {re.sub(r"^module\.(backbone\.)?", "", k): v
                for k, v in to_ponderv2_state_dict(net).items()}
    if isinstance(net, ResNetTorchVision):
        for key, v in sd.items():
            mod, leaf = key.rsplit(".", 1)
            mod = re.sub(r"^layer(\d)_(\d+)", r"layer\1.\2", mod)
            mod = mod.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                          "downsample.1")
            is_bn = re.search(r"(^|\.)(bn\d|downsample\.1)$", mod) is not None
            out[f"{resnet_prefix}{mod}.{_BN[leaf] if is_bn else leaf}"] = v
            if is_bn and leaf == "var":
                out[f"{resnet_prefix}{mod}.num_batches_tracked"] = torch.tensor(7)
        return out
    if isinstance(net, ViT):
        for key, v in sd.items():
            if key.startswith("model.blocks_"):
                continue
            key = key[len("model."):].replace("patch_embed_proj", "patch_embed.proj")
            out[key] = v
        _blocks(out, sd, "blocks", "model.blocks")
        return out
    if isinstance(net, MultiViTModel):
        out["global_tokens"] = sd["model.global_tokens"]
        for key, v in sd.items():
            m = re.match(r"model\.input_adapters_(\w+)\.proj\.(weight|bias)$", key)
            if m:
                out[f"input_adapters.{m[1]}.proj.{m[2]}"] = v
        _blocks(out, sd, "encoder", "model.encoder")
        return out
    raise NotImplementedError(f"no reference layout for a {type(net).__name__}")


def _mha_and_names(sd: dict) -> dict:
    """ACT's transformer entries: the attentions' q / k / v stacked into
    ``in_proj``, ``out`` as ``out_proj``; the rest as they are."""
    out = {}
    for key, v in sd.items():
        m = re.match(r"(.*\.(self_attn|multihead_attn))\.(query|key|value|out)\.(weight|bias)$",
                     key)
        if not m:
            out[key] = v
        elif m[3] == "out":
            out[f"{m[1]}.out_proj.{m[4]}"] = v
        elif m[3] == "query":
            out[f"{m[1]}.in_proj_{m[4]}"] = torch.cat(
                [sd[f"{m[1]}.{p}.{m[4]}"] for p in ("query", "key", "value")])
    return out


def _act(policy: ACT, resnet_prefix: str) -> dict:
    sd = {k: v for k, v in _state(policy).items() if not k.startswith("backbone.")}
    out = {}
    for key, v in _mha_and_names(sd).items():
        if key in ("cls_embed", "query_embed", "additional_pos_embed"):
            out[f"{key}.weight"] = v
        elif key == "state_pos_embed":
            out["pos.weight"] = v  # the reference's state-only position table
        elif key == "input_proj.weight":
            out[key] = v[:, :, None, None]  # the reference's 1 x 1 convolution
        elif key.startswith("pcd_linear."):
            out["linear." + key.split(".", 1)[1]] = v
        elif key.startswith("pcd_bn."):
            if key.endswith(".scale"):
                _bn(out, "bn", sd, "pcd_bn")
        else:
            out[key] = v
    if policy.backbone is not None:
        for key, v in backbone_state_dict(policy.backbone, resnet_prefix).items():
            out[f"backbone.{key}"] = v
    return out


def _unet(sd: dict) -> dict:
    rules = (
        (r"^time_mlp1\.", "diffusion_step_encoder.1."),
        (r"^time_mlp2\.", "diffusion_step_encoder.3."),
        (r"^final_conv\.", "final_conv.1."),
        (r"^final_block\.", "final_conv.0."),
        (r"^local_down\.", "local_cond_encoder.0."),
        (r"^local_up\.", "local_cond_encoder.1."),
        (r"^down(\d+)_res(\d)\.", r"down_modules.\1.\2."),
        (r"^down(\d+)_ds\.", r"down_modules.\1.2."),
        (r"^mid_res(\d)\.", r"mid_modules.\1."),
        (r"^up(\d+)_res(\d)\.", r"up_modules.\1.\2."),
        (r"^up(\d+)_us\.", r"up_modules.\1.2."),
        (r"\.block(\d)\.", r".blocks.\1."),
        (r"\.conv\.(weight|bias)$", r".block.0.\1"),
        (r"\.norm\.(weight|bias)$", r".block.1.\1"),
        (r"\.cond_encoder\.", ".cond_encoder.1."),
    )
    out = {}
    for key, v in sd.items():
        ds_or_us = re.match(r"^(down|up)\d+_(ds|us)\.", key)
        for pattern, repl in rules:
            if ds_or_us and pattern.startswith(r"\.conv"):
                continue  # a sampler's conv is ``<i>.2.conv``, no Conv1dBlock
            key = re.sub(pattern, repl, key)
        out[f"model.{key}"] = v
    return out


def _pcd_encoder(enc, sd: dict) -> dict:
    out = {"linear.weight": sd["linear.weight"]}
    _bn(out, "bn", sd, "bn")
    L = enc.projector_layers
    for j in range(L):
        out[f"projector.{3 * j}.weight"] = sd[f"projector_conv{j}.weight"][:, :, None]
        out[f"projector.{3 * j}.bias"] = sd[f"projector_conv{j}.bias"]
        _bn(out, f"projector.{3 * j + 1}", sd, f"projector_bn{j}")
    out[f"projector.{3 * L + 1}.weight"] = sd["projector_out.weight"][:, :, None]
    out[f"projector.{3 * L + 1}.bias"] = sd["projector_out.bias"]
    _bn(out, f"projector.{3 * L + 2}", sd, "projector_out_bn")
    for key, v in backbone_state_dict(enc.pcd_model).items():
        out[f"pcd_model.{key}"] = v
    return out


def _dp(policy: DiffusionUnetImagePolicy, normalizer: Optional[dict]) -> dict:
    out = _unet({k[len("model."):]: v for k, v in _state(policy).items()
                 if k.startswith("model.")})
    enc = policy.obs_encoder
    if isinstance(enc, MultiImageObsEncoder):
        models = {"rgb": enc.rgb_model} if enc.share_rgb_model else enc.key_models()
        for name, net in models.items():
            for key, v in backbone_state_dict(net).items():
                out[f"obs_encoder.key_model_map.{name}.{key}"] = v
    else:
        for key, v in _pcd_encoder(enc, _state(enc)).items():
            out[f"obs_encoder.{key}"] = v
    for field, entry in (normalizer or {}).items():
        prefix = f"normalizer.params_dict.{field}"
        out[f"{prefix}.scale"] = torch.as_tensor(entry["scale"]).clone()
        out[f"{prefix}.offset"] = torch.as_tensor(entry["offset"]).clone()
        for k, v in (entry.get("input_stats") or {}).items():
            out[f"{prefix}.input_stats.{k}"] = torch.as_tensor(v).clone()
    return out


def reference_state_dict(policy: torch.nn.Module, normalizer: Optional[dict] = None,
                         resnet_prefix: str = "0.body.") -> dict:
    """The reference's ``state_dict`` of ``policy`` (ACT / ACTPCD or the
    Diffusion Policy), without the ``policy.`` prefix; ``normalizer`` is a
    ``LinearNormalizer.state_dict()`` for the DP's ``normalizer`` entries,
    ``resnet_prefix`` the ACT ResNet's place under ``backbone.``."""
    if isinstance(policy, ACT):
        return _act(policy, resnet_prefix)
    if isinstance(policy, DiffusionUnetImagePolicy):
        return _dp(policy, normalizer)
    raise NotImplementedError(f"no reference layout for a {type(policy).__name__}")


def save_lightning_ckpt(path: str, state_dict: dict, epoch: int = 3, global_step: int = 123
                        ) -> None:
    """A Lightning ``.ckpt``: ``policy.<key>`` entries beside a metric's
    state, the epoch and the step."""
    sd = {f"policy.{k}": v for k, v in state_dict.items()}
    sd["train_metrics.metrics.0.mean_value"] = torch.tensor(0.5)
    torch.save({"state_dict": sd, "epoch": epoch, "global_step": global_step}, path)
