"""Convert a reference PyTorch Lightning checkpoint to the port's checkpoint
(port of ``scripts/port_reference_ckpt.py``, which writes the JAX
package's Orbax checkpoint).

The reference's ``ModelCheckpoint`` writes a ``.ckpt`` whose
``state_dict`` holds ``policy.*``; this maps it onto the port's policy, by
the names the JAX script gives the flax trees (which ``flax_to_torch``
carries to the port one to one), and writes the directory that
``Trainer.save_checkpoint(weights_only=True)`` writes: one ``torch.save``
file with ``params`` and ``batch_stats`` under the port's names, ``step``
0, ``epoch`` -1 (nothing trained yet: a restoring trainer starts at epoch
0), and, for the Diffusion Policy, the normalizer in ``extras`` as
``LinearNormalizer.state_dict()`` holds it. ``ckpt_path=<out_dir>`` of
``python -m pointcloudmatters_tpu_torch.train`` / ``.validate`` and
``Trainer.restore_checkpoint`` take it as it is::

    python -m pointcloudmatters_tpu_torch.port_reference_ckpt <lightning.ckpt> <out_dir> \\
        [--policy auto|act|dp] [--nhead 8] [--dry-run]

Families (the policy told from the keys, or ``--policy``):

- ACT and ACTPCD: the CVAE's projections, heads and embeddings, both
  transformer stacks, the point-cloud token builder (``linear``, ``bn``),
  and the backbone: PointNet (spconv k = 1 planes), SpUNet (spconv planes,
  PDBatchNorm), ResNet (a DETR ``Joiner``'s ``0.body`` or direct
  torchvision / R3M keys), ViT (base/16, large/16) or MultiViT / MultiMAE;
- the Diffusion Policy: the ConditionalUnet1D, the point-cloud encoder or
  the image encoder (``key_model_map``: ``rgb`` shared, else one model a
  key) and the ``LinearNormalizer``.

Architectures are inferred from the shapes; an unknown ResNet depth, ViT
width, depth or patch, or MultiViT width is refused, as in the JAX script.
Both sides are torch, so most entries are renames; the layouts that
differ: ``nn.MultiheadAttention``'s ``in_proj`` splits into the port's
``query`` / ``key`` / ``value`` linears, spconv k = 1 planes
``(out, 1, 1, 1, in)`` and Conv1d k = 1 weights become linears, SpUNet's
planes become ``(k^3, in, out)`` (``pcd_encoder/spunet.py``), a 1 x 1
``input_proj`` convolution becomes a linear, and the state-only ACT's
``pos.weight`` becomes ``state_pos_embed``. ``--nhead`` is accepted for
the JAX script's command line and not needed: a split by rows is the same
for every head count.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.models.components.img_encoder.multivit import (
    MultiViTModel,
    multimae_state_dict,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import (
    ResNetTorchVision,
    resnet_state_dict,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import ViT, vit_state_dict
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet import (
    SpUNet,
    ponderv2_state_dict,
)
from pointcloudmatters_tpu_torch.trainer import write_checkpoint

__all__ = ["port_state_dict", "main", "SD"]


class SD:
    """A flat reference state dict, sliced by prefix."""

    def __init__(self, d: dict):
        self.d = dict(d)

    def sub(self, prefix: str) -> "SD":
        p = prefix + "."
        return SD({k[len(p):]: v for k, v in self.d.items() if k.startswith(p)})

    def __contains__(self, key: str) -> bool:
        return key in self.d or any(k.startswith(key + ".") for k in self.d)

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.d[key]

    def keys(self):
        return self.d.keys()

    def layer_indices(self, prefix: str) -> list[int]:
        p = prefix + "."
        return sorted({int(h) for k in self.d if k.startswith(p)
                       for h in [k[len(p):].split(".", 1)[0]] if h.isdigit()})


class Tree:
    """The port's parameters and batch statistics being filled, by name."""

    def __init__(self):
        self.params: dict[str, torch.Tensor] = {}
        self.stats: dict[str, torch.Tensor] = {}

    def put(self, prefix: str, entries: dict, stats: bool = False) -> None:
        into = self.stats if stats else self.params
        for k, v in entries.items():
            into[f"{prefix}.{k}" if prefix else k] = v


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def linear(t: Tree, dst: str, sd: SD, src: str, weight: Optional[torch.Tensor] = None) -> None:
    """A linear (or a layer whose weight becomes one): weight, and bias where
    the reference has one."""
    t.params[f"{dst}.weight"] = sd[f"{src}.weight"] if weight is None else weight
    if f"{src}.bias" in sd.keys():
        t.params[f"{dst}.bias"] = sd[f"{src}.bias"]


def layernorm(t: Tree, dst: str, sd: SD, src: str) -> None:
    t.params[f"{dst}.weight"] = sd[f"{src}.weight"]
    t.params[f"{dst}.bias"] = sd[f"{src}.bias"]


def batchnorm(t: Tree, dst: str, sd: SD, src: str) -> None:
    """``nn.BatchNorm1d`` -> the port's batch norm: ``scale``, ``bias``
    parameters, ``mean``, ``var`` statistics."""
    t.params[f"{dst}.scale"] = sd[f"{src}.weight"]
    t.params[f"{dst}.bias"] = sd[f"{src}.bias"]
    t.stats[f"{dst}.mean"] = sd[f"{src}.running_mean"]
    t.stats[f"{dst}.var"] = sd[f"{src}.running_var"]


def mha(t: Tree, dst: str, sd: SD, src: str) -> None:
    """``nn.MultiheadAttention``: ``in_proj`` split by rows into ``query``,
    ``key``, ``value``; ``out_proj`` as ``out``."""
    w, b = sd[f"{src}.in_proj_weight"], sd[f"{src}.in_proj_bias"]
    d = w.shape[1]
    for i, name in enumerate(("query", "key", "value")):
        t.params[f"{dst}.{name}.weight"] = w[i * d:(i + 1) * d]
        t.params[f"{dst}.{name}.bias"] = b[i * d:(i + 1) * d]
    linear(t, f"{dst}.out", sd, f"{src}.out_proj")


def spconv_k1(sd: SD, src: str) -> torch.Tensor:
    """spconv 2's k = 1 ``(out, 1, 1, 1, in)`` plane as a linear's (out, in)."""
    w = sd[f"{src}.weight"].squeeze()
    if w.ndim != 2:
        raise ValueError(f"not a k=1 sparse conv weight: shape {tuple(sd[f'{src}.weight'].shape)}")
    return w


# ---------------------------------------------------------------------------
# transformer stacks (reference `act/transformer.py`)
# ---------------------------------------------------------------------------

def encoder_layer(t: Tree, dst: str, sd: SD, src: str) -> None:
    mha(t, f"{dst}.self_attn", sd, f"{src}.self_attn")
    for name in ("linear1", "linear2"):
        linear(t, f"{dst}.{name}", sd, f"{src}.{name}")
    for name in ("norm1", "norm2"):
        layernorm(t, f"{dst}.{name}", sd, f"{src}.{name}")


def decoder_layer(t: Tree, dst: str, sd: SD, src: str) -> None:
    for name in ("self_attn", "multihead_attn"):
        mha(t, f"{dst}.{name}", sd, f"{src}.{name}")
    for name in ("linear1", "linear2"):
        linear(t, f"{dst}.{name}", sd, f"{src}.{name}")
    for name in ("norm1", "norm2", "norm3"):
        layernorm(t, f"{dst}.{name}", sd, f"{src}.{name}")


def transformer_encoder(t: Tree, dst: str, sd: SD, src: str) -> None:
    for i in sd.layer_indices(f"{src}.layers"):
        encoder_layer(t, f"{dst}.layers.{i}", sd, f"{src}.layers.{i}")
    if f"{src}.norm.weight" in sd.keys():
        layernorm(t, f"{dst}.norm", sd, f"{src}.norm")


def transformer(t: Tree, dst: str, sd: SD, src: str) -> None:
    for i in sd.layer_indices(f"{src}.decoder.layers"):
        decoder_layer(t, f"{dst}.decoder.layers.{i}", sd, f"{src}.decoder.layers.{i}")
    layernorm(t, f"{dst}.decoder.norm", sd, f"{src}.decoder.norm")
    transformer_encoder(t, f"{dst}.encoder", sd, f"{src}.encoder")


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

def _as_stats(entries: dict, module: torch.nn.Module) -> tuple[dict, dict]:
    """A module's state-dict entries split into parameters and buffers."""
    names = {n for n, _ in module.named_parameters()}
    return ({k: v for k, v in entries.items() if k in names},
            {k: v for k, v in entries.items() if k not in names})


def _put_module(t: Tree, dst: str, entries: dict, module: torch.nn.Module) -> None:
    params, stats = _as_stats(entries, module)
    t.put(dst, params)
    t.put(dst, stats, stats=True)


def pointnet_backbone(t: Tree, dst: str, sd: SD) -> None:
    """The reference's spconv PointNet: ``conv<i>.0`` a k = 1 SubMConv3d,
    ``conv<i>.1`` a BatchNorm1d; ``final`` a k = 1 SubMConv3d."""
    for i in range(1, 6):
        linear(t, f"{dst}.conv{i}", sd, f"conv{i}.0", spconv_k1(sd, f"conv{i}.0"))
        batchnorm(t, f"{dst}.bn{i}", sd, f"conv{i}.1")
    if "final.weight" in sd.keys():
        linear(t, f"{dst}.final", sd, "final", spconv_k1(sd, "final"))


def spunet_backbone(t: Tree, dst: str, sd: SD) -> None:
    """The reference's SpUNet, its architecture (base and stage widths,
    blocks a stage, conditions, adaptive norms) from the shapes, through
    PonderV2's mapping (``ponderv2_state_dict``); entries the checkpoint
    does not set keep the port's initial values, as the JAX script keeps
    its ``init``'s."""
    w_in = sd["conv_input.conv.weight"]  # (out, 5, 5, 5, in)
    in_ch, base = int(w_in.shape[-1]), int(w_in.shape[0])
    S = len(sd.layer_indices("down"))
    enc_ch = [int(sd[f"enc.{s}.block0.conv2.weight"].shape[0]) for s in range(S)]
    dec_out = [int(sd[f"dec.{s}.block0.conv2.weight"].shape[0]) for s in range(S)]
    channels = tuple(enc_ch) + tuple(dec_out[2 * S - 1 - p] for p in range(S, 2 * S))

    def blocks(kind: str, s: int) -> int:
        return len([k for k in sd.keys()
                    if k.startswith(f"{kind}.{s}.block") and k.endswith(".conv1.weight")])

    layers = tuple(blocks("enc", s) for s in range(S)) + tuple(
        blocks("dec", 2 * S - 1 - p) for p in range(S, 2 * S))
    n_cond = len({k.split(".")[3] for k in sd.keys() if k.startswith("conv_input.bn.bns.")})
    adaptive = any(".modulation." in k for k in sd.keys())
    num_classes = int(sd["final.weight"].shape[0]) if "final.weight" in sd.keys() else 0
    conditions = tuple(f"cond{i}" for i in range(max(n_cond, 1)))
    ctx = (int(sd["conv_input.bn.modulation.1.weight"].shape[1])
           if adaptive and "conv_input.bn.modulation.1.weight" in sd.keys() else 256)
    model = SpUNet(in_channels=in_ch, num_classes=num_classes, base_channels=base,
                   channels=channels, layers=layers, conditions=conditions,
                   norm_adaptive=adaptive, context_channels=ctx)
    entries = dict(model.state_dict())
    entries.update(ponderv2_state_dict(
        model, {f"module.backbone.{k}": v for k, v in sd.d.items()}))
    _put_module(t, dst, entries, model)


def vit_backbone(t: Tree, dst: str, sd: SD) -> None:
    """timm / MAE ViT keys; base/16 or large/16 from the shapes."""
    pe = sd["patch_embed.proj.weight"]  # (D, C, p, p)
    embed_dim, in_ch, patch = int(pe.shape[0]), int(pe.shape[1]), int(pe.shape[2])
    depth = len(sd.layer_indices("blocks"))
    name = {(768, 12, 16): "vit_base_patch16",
            (1024, 24, 16): "vit_large_patch16"}.get((embed_dim, depth, patch))
    if name is None:
        raise ValueError(f"unrecognized ViT architecture: embed_dim={embed_dim}, "
                         f"depth={depth}, patch={patch} (known: base/16 and large/16)")
    model = ViT(model_name=name, channels=in_ch)
    _put_module(t, dst, vit_state_dict(model, dict(sd.d)), model)


def multivit_backbone(t: Tree, dst: str, sd: SD) -> None:
    """The MultiMAE / MultiViT trunk; its width and depth from the shapes."""
    dim = int(sd["input_adapters.rgb.proj.weight"].shape[0])
    depth = len(sd.layer_indices("encoder"))
    heads = {768: 12, 1024: 16}.get(dim)
    if heads is None:
        raise ValueError(f"unrecognized MultiViT dim_tokens={dim}")
    with torch.device("meta"):
        model = MultiViTModel(dim_tokens=dim, depth=depth, num_heads=heads, img_size=224)
    _put_module(t, dst, multimae_state_dict(model, dict(sd.d)), model)


_RESNETS = {("basic", (2, 2, 2, 2)): "resnet18", ("basic", (3, 4, 6, 3)): "resnet34",
            ("bottleneck", (3, 4, 6, 3)): "resnet50"}


def resnet_backbone(t: Tree, dst: str, sd: SD, channels: int) -> None:
    """torchvision / R3M ResNet keys (``module.``, ``convnet.``,
    ``resnet.`` prefixes allowed); its depth from the blocks."""
    stripped = {k.split("convnet.")[-1].split("module.")[-1] for k in sd.keys()}
    kind = "bottleneck" if any("layer1.0.conv3" in k for k in stripped) else "basic"
    per_stage = tuple(len({k.split(f"layer{st}.")[1].split(".")[0]
                           for k in stripped if f"layer{st}." in k}) for st in (1, 2, 3, 4))
    arch = _RESNETS.get((kind, per_stage))
    if arch is None:
        raise ValueError(f"unrecognized torchvision ResNet layout: {kind} blocks {per_stage}")
    with torch.device("meta"):
        model = ResNetTorchVision(resnet_model=arch, channels=channels, resize_to=64)
    _put_module(t, dst, resnet_state_dict(model, dict(sd.d)), model)


def any_backbone(t: Tree, dst: str, bsd: SD) -> None:
    """An encoder's entries by family: PointNet, SpUNet, ViT, MultiViT, a
    DETR ``Joiner``'s ResNet, or a direct ResNet."""
    if "conv1.0.weight" in bsd.keys():
        return pointnet_backbone(t, dst, bsd)
    if "conv_input.conv.weight" in bsd.keys():
        return spunet_backbone(t, dst, bsd)
    if "patch_embed.proj.weight" in bsd.keys():
        return vit_backbone(t, dst, bsd)
    if "input_adapters.rgb.proj.weight" in bsd.keys():
        return multivit_backbone(t, dst, bsd)
    if any(k.startswith("0.body.") for k in bsd.keys()):
        rsd = bsd.sub("0").sub("body")
        return resnet_backbone(t, dst, rsd, int(rsd["conv1.weight"].shape[1]))
    if any(k.endswith("layer1.0.conv1.weight") for k in bsd.keys()):
        conv1 = next(k for k in bsd.keys() if k.endswith("conv1.weight")
                     and "layer" not in k and "downsample" not in k)
        return resnet_backbone(t, dst, bsd, int(bsd[conv1].shape[1]))
    raise ValueError("unrecognized encoder backbone keys: " + ", ".join(sorted(bsd.keys())[:5]))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def act_policy(sd: SD) -> Tree:
    """ACT and ACTPCD (reference ``act/act.py``)."""
    t = Tree()
    for name in ("cls_embed", "query_embed", "additional_pos_embed"):
        if f"{name}.weight" in sd.keys():
            t.params[name] = sd[f"{name}.weight"]
    # the reference names the state-only ACT's position table ``pos``
    # (its ``act/act.py:244`` reads ``self.pos.weight``); the port's is
    # ``state_pos_embed``
    if "pos.weight" in sd.keys():
        t.params["state_pos_embed"] = sd["pos.weight"]
    for name in ("encoder_action_proj", "encoder_joint_proj", "latent_proj", "latent_out_proj",
                 "input_proj_robot_state", "action_head", "is_pad_head", "proj_goal_cond_emb",
                 "input_proj_env_state"):
        if f"{name}.weight" in sd.keys():
            linear(t, name, sd, name)
    transformer(t, "transformer", sd, "transformer")
    if "encoder.layers" in sd:
        transformer_encoder(t, "encoder", sd, "encoder")
    if "input_proj.weight" in sd.keys():
        w = sd["input_proj.weight"]
        linear(t, "input_proj", sd, "input_proj", w[:, :, 0, 0] if w.ndim == 4 else None)
    if "linear.weight" in sd.keys():
        linear(t, "pcd_linear", sd, "linear")
    if "bn.weight" in sd.keys():
        batchnorm(t, "pcd_bn", sd, "bn")
    if "backbone" in sd:
        any_backbone(t, "backbone", sd.sub("backbone"))
    return t


def unet(t: Tree, dst: str, sd: SD, src: str) -> None:
    """ConditionalUnet1D (reference ``diffusion/conditional_unet1d.py``):
    a ``Conv1dBlock`` is ``block.0`` (Conv1d) and ``block.1`` (GroupNorm);
    Conv1d and ConvTranspose1d weights keep their torch layout."""

    def block(bd: str, bs: str) -> None:
        linear(t, f"{bd}.conv", sd, f"{bs}.block.0")
        layernorm(t, f"{bd}.norm", sd, f"{bs}.block.1")

    def resblock(rd: str, rs: str) -> None:
        block(f"{rd}.block0", f"{rs}.blocks.0")
        block(f"{rd}.block1", f"{rs}.blocks.1")
        linear(t, f"{rd}.cond_encoder", sd, f"{rs}.cond_encoder.1")
        if f"{rs}.residual_conv.weight" in sd.keys():
            linear(t, f"{rd}.residual_conv", sd, f"{rs}.residual_conv")

    linear(t, f"{dst}.time_mlp1", sd, f"{src}.diffusion_step_encoder.1")
    linear(t, f"{dst}.time_mlp2", sd, f"{src}.diffusion_step_encoder.3")
    block(f"{dst}.final_block", f"{src}.final_conv.0")
    linear(t, f"{dst}.final_conv", sd, f"{src}.final_conv.1")
    if f"{src}.local_cond_encoder.0.blocks.0.block.0.weight" in sd.keys():
        resblock(f"{dst}.local_down", f"{src}.local_cond_encoder.0")
        resblock(f"{dst}.local_up", f"{src}.local_cond_encoder.1")
    for i in sd.layer_indices(f"{src}.down_modules"):
        ds = f"{src}.down_modules.{i}"
        resblock(f"{dst}.down{i}_res0", f"{ds}.0")
        resblock(f"{dst}.down{i}_res1", f"{ds}.1")
        if f"{ds}.2.conv.weight" in sd.keys():
            linear(t, f"{dst}.down{i}_ds.conv", sd, f"{ds}.2.conv")
    resblock(f"{dst}.mid_res0", f"{src}.mid_modules.0")
    resblock(f"{dst}.mid_res1", f"{src}.mid_modules.1")
    for i in sd.layer_indices(f"{src}.up_modules"):
        us = f"{src}.up_modules.{i}"
        resblock(f"{dst}.up{i}_res0", f"{us}.0")
        resblock(f"{dst}.up{i}_res1", f"{us}.1")
        if f"{us}.2.conv.weight" in sd.keys():
            linear(t, f"{dst}.up{i}_us.conv", sd, f"{us}.2.conv")


def pcd_obs_encoder(t: Tree, dst: str, sd: SD, src: str) -> None:
    """The DP's point-cloud encoder (reference ``vision/pcd_obs_encoder.py``):
    its projector ``Sequential`` of [Conv1d k = 1, BatchNorm1d, ReLU] x L,
    max pool, Conv1d, BatchNorm1d."""
    linear(t, f"{dst}.linear", sd, f"{src}.linear")
    batchnorm(t, f"{dst}.bn", sd, f"{src}.bn")
    bsd = sd.sub(f"{src}.pcd_model")
    if "conv1.0.weight" in bsd.keys():
        pointnet_backbone(t, f"{dst}.pcd_model", bsd)
    proj = sd.sub(f"{src}.projector")
    heads = {k.split(".")[0] for k in proj.keys() if k.split(".")[0].isdigit()}
    conv_idx = sorted(int(h) for h in heads
                      if f"{h}.weight" in proj.keys() and proj[f"{h}.weight"].ndim == 3)
    bn_idx = sorted(int(h) for h in heads if f"{h}.running_mean" in proj.keys())

    def conv(dst_name: str, i: int) -> None:
        linear(t, f"{dst}.{dst_name}", sd, f"{src}.projector.{i}",
               sd[f"{src}.projector.{i}.weight"][:, :, 0])

    for j, (ci, bi) in enumerate(zip(conv_idx[:-1], bn_idx[:-1])):
        conv(f"projector_conv{j}", ci)
        batchnorm(t, f"{dst}.projector_bn{j}", sd, f"{src}.projector.{bi}")
    conv("projector_out", conv_idx[-1])
    batchnorm(t, f"{dst}.projector_out_bn", sd, f"{src}.projector.{bn_idx[-1]}")


def multi_image_obs_encoder(t: Tree, dst: str, sd: SD, src: str) -> None:
    """The DP's image encoder: ``key_model_map.rgb`` (shared) as
    ``rgb_model``, ``key_model_map.<key>`` as ``model_<key>``."""
    kmm = sd.sub(f"{src}.key_model_map")
    for m in sorted({k.split(".", 1)[0] for k in kmm.keys()}):
        any_backbone(t, f"{dst}.{'rgb_model' if m == 'rgb' else f'model_{m}'}", kmm.sub(m))


def normalizer(sd: SD, src: str) -> dict:
    """The reference ``LinearNormalizer``'s ``params_dict.<field>.{scale,
    offset,input_stats.*}`` as the port's ``LinearNormalizer.state_dict()``."""
    pd = sd.sub(f"{src}.params_dict")
    out = {}
    for field in sorted({k.split(".", 1)[0] for k in pd.keys()}):
        fsd = pd.sub(field)
        out[field] = {"scale": fsd["scale"], "offset": fsd["offset"],
                      "input_stats": {k.split(".", 1)[1]: v for k, v in fsd.d.items()
                                      if k.startswith("input_stats.")}}
    return out


def dp_policy(sd: SD) -> tuple[Tree, dict]:
    """The Diffusion Policy (reference ``diffusion_unet_image_policy.py``):
    (its tree, extras)."""
    t = Tree()
    unet(t, "model", sd, "model")
    if "obs_encoder.linear.weight" in sd.keys():
        pcd_obs_encoder(t, "obs_encoder", sd, "obs_encoder")
    elif "obs_encoder.key_model_map" in sd:
        multi_image_obs_encoder(t, "obs_encoder", sd, "obs_encoder")
    extras = {}
    if "normalizer.params_dict" in sd:
        extras["normalizer"] = normalizer(sd, "normalizer")
    return t, extras


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def port_state_dict(state_dict: dict, policy: str = "auto") -> dict:
    """A Lightning ``state_dict`` -> the port's checkpoint dict (module doc)."""
    sd = SD({(k[len("policy."):] if k.startswith("policy.") else k): torch.as_tensor(v)
             for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")
             and not k.startswith(("train_metrics", "val_metrics", "best_val_metrics"))})
    if policy == "auto":
        policy = "dp" if "model.diffusion_step_encoder.1.weight" in sd.keys() else "act"
    extras: dict = {}
    if policy == "act":
        t = act_policy(sd)
    elif policy == "dp":
        t, extras = dp_policy(sd)
    else:
        raise ValueError(f"unknown policy {policy!r} (use auto|act|dp)")
    # own storage each: a slice saved as it is would carry its whole source
    item = {"params": {k: v.clone(memory_format=torch.contiguous_format)
                       for k, v in t.params.items()},
            "batch_stats": {k: v.clone(memory_format=torch.contiguous_format)
                            for k, v in t.stats.items()},
            "step": 0, "epoch": -1}
    if extras:
        item["extras"] = extras
    return item


def _sizes(tree: dict) -> int:
    return sum(v.numel() for v in tree.values())


def main(argv=None) -> Optional[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="the reference's Lightning .ckpt")
    ap.add_argument("out", help="the checkpoint directory to write")
    ap.add_argument("--policy", default="auto", choices=["auto", "act", "dp"])
    ap.add_argument("--nhead", type=int, default=8,
                    help="attention heads (the JAX script's; the port's split needs none)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the mapped entries without writing")
    args = ap.parse_args(argv)
    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state_dict = raw.get("state_dict", raw)
    item = port_state_dict({k: v.detach() if hasattr(v, "detach") else torch.as_tensor(
        np.asarray(v)) for k, v in state_dict.items()}, policy=args.policy)
    n = _sizes(item["params"])
    if args.dry_run:
        print(f"would port {n:,} parameters (dry run):")
        groups: dict = {}
        for k, v in item["params"].items():
            head = re.split(r"\.", k, maxsplit=1)[0]
            groups[head] = groups.get(head, 0) + v.numel()
        for head in sorted(groups):
            print(f"  {head}/  ({groups[head]:,} params)")
        print(f"  batch_stats: {len(item['batch_stats'])} tensors")
        if item.get("extras"):
            print(f"  extras: {sorted(item['extras'])}")
        return None
    out = os.path.abspath(args.out)
    write_checkpoint(out, item)
    print(f"ported {n:,} parameters -> {out}")
    return out


if __name__ == "__main__":
    main()
