"""The flagship model, the Diffusion Policy at its shipped widths, and
synthetic batches of the port (port of ``__graft_entry__.build_flagship`` /
``build_batch`` / ``_build_dp_batch``).

``build_flagship()`` is ACTPCD + PointNet at the published scale of
``configs/model/maniskill2_act_pcd_model.yaml``: hidden 512, 8 heads, 4
encoder layers, 7 decoder layers of which 1 is computed, feed-forward 32,
chunk 100, FPS to 2048 tokens, kNN k=16; 24,124,456 parameters. Weights are
drawn from a seeded ``torch.Generator``; ``dropout`` is the config's 0.1
unless given (tests build it at 0). It is built on the card unless the
caller asks for another device. ``freeze_backbone`` trains the ACT head over
a fixed PointNet (a model field users set by override; its token builder
takes the data-source kernels under bf16), ``pre_sample`` is the
``scratch_pointnet_pcd_presample`` variant, and ``attention_impl`` the
encoder's attention backend (``model.policy.transformer.attention_impl``:
``"oneshot"`` as shipped, or ``"fused"``, ``"flash"`` or ``"dense"``). ``build_batch()``
is the same numpy batch the JAX entry builds from the same seed.

``build_flagship(backbone="spunet")`` is ``scratch_spunet_pcd``
(``configs/exp_maniskill2_act_policy/maniskill2_model``): the same ACT
head over SpUNet (in_channels 6, 96 output channels, or ``num_classes`` =
hidden under ``pre_sample``); ``spunet`` overrides its widths (tests use
tiny ones). ``build_grid_batch()`` is a batch whose clouds carry
``grid_coord``, the 5 mm voxels of a table-top scene, unique a cloud, as
``GridSamplePCD`` leaves them.

``build_image_policy()`` is ACT over camera images, the policy of the
image configs of ``configs/exp_maniskill2_act_policy/maniskill2_model``
(``configs/model/maniskill2_act_model.yaml``: the same head, the 2-D sine
position embedding of 256 + 256 features, one camera) over ResNet-50
(``backbone="resnet"``, 1, 3, 4 or 6 ``channels``: depth-only, RGB, RGB-D,
pointmap), ViT-B/16 (``"vit"``) or the MultiViT-B trunk (``"multivit"``,
RGB-D); ``backbone_kw`` overrides the backbone's arguments (tests use tiny
widths). ``build_image_batch()`` is a batch of (B, 1, side, side,
channels) images as the RGB-D and pointmap datasets scale them.

``build_dp_policy()`` is the Diffusion Policy over point clouds of
``configs/exp_maniskill2_diffusion_policy`` (``scratch_pointnet_pcd``,
PickCube-v0): PointNet to 96 channels, FPS to 2048 tokens, kNN k=16, the
projector [96, 128, 128], two observation frames, horizon 16, 8 executed
steps, a DDPM of 100 steps (``squaredcos_cap_v2``), and the
ConditionalUnet1D with step embedding 128, ``down_dims`` [512, 1024, 2048],
kernel 5, 8 groups and FiLM scales: 255,687,303 UNet parameters.
``build_dp_batch()`` is a batch of its data in the collate layout.

``build_image_dp_policy()`` is the Diffusion Policy over camera images, the
policy of the image configs of ``configs/exp_maniskill2_diffusion_policy``
(PickCube-v0's RGB-D task): the same UNet and scheduler over the
``MultiImageObsEncoder`` of ``configs/model/maniskill2_diffusion_policy_model.yaml``
(resize to 256, centre crop 224, one shared model) with ResNet-50
(``backbone="resnet"``: 1, 3, 4 or 6 ``channels``, depth-only, RGB,
RGB-D, pointmap), ViT-B/16 (``"vit"``) or the MultiViT-B trunk
(``"multivit"``, RGB-D); ``share_rgb_model=False`` gives each camera its
own copy, ``cameras`` names the cameras, and ``backbone_kw`` /
``encoder_kw`` override the backbone's and the encoder's arguments (tests
use tiny widths). ``build_image_dp_batch()`` is a batch of its data as the
DP RGB-D datasets and the default collate give it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Union

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.data.collate import morton_order
from pointcloudmatters_tpu_torch.data.components.rlbench.constants import SCENE_BOUNDS, loc_bounds
from pointcloudmatters_tpu_torch.models.components.act.act import ACT, ACTPCD
from pointcloudmatters_tpu_torch.models.components.act.positional_encoding import (
    PositionEmbeddingSine,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.multivit import MultiViTModel
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import ResNetTorchVision
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import ViT
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.ddpm import (
    DDPMScheduler,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion_unet_image_policy import (  # noqa: E501
    DiffusionUnetImagePolicy,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.multi_image_obs_encoder import (  # noqa: E501
    MultiImageObsEncoder,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.pcd_obs_encoder import (  # noqa: E501
    PCDObsEncoder,
)
from pointcloudmatters_tpu_torch.models.components.act.transformer import (
    Transformer,
    TransformerEncoder,
)
from pointcloudmatters_tpu_torch.models.components.nn_utils import (
    GroupedBNReluMax,
    MaskedBatchNorm,
)
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import (
    WIDTHS,
    PointNet,
)
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet import SpUNet

__all__ = ["build_flagship", "build_batch", "build_grid_batch", "build_image_policy",
           "build_image_batch", "build_state_policy", "build_state_batch", "build_dp_policy", "build_dp_batch", "build_image_dp_policy",
           "build_image_dp_batch", "image_dp_shape_meta", "init_parameters", "morton_order",
           "write_rlbench_episodes", "DP_SHAPE_META", "GRID_SIZE"]

GRID_SIZE = 0.005  # m, the configs' GridSamplePCD grid

# the data of the shipped DP composition (PickCube-v0's shape_meta)
DP_SHAPE_META = {
    "action": {"shape": [7]},
    "obs": {"pcds": {"shape": [6], "type": "pcd"}, "qpos": {"shape": [9], "type": "low_dim"}},
    "goal": {"task_emb": {"shape": [3]}},
}


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw the weights the way the JAX modules initialise theirs, from
    ``generator`` (a CPU generator): linear and convolution weights normal
    with std 1/sqrt(fan_in) (a convolution's fan-in is its input channels
    times its width), biases zero, layer and group norms one/zero, the
    learned embeddings (parameters a module owns directly, such as ACT's
    ``query_embed``) standard normal, an ``nn.Embedding`` normal with std
    1/sqrt(width) (flax's ``Embed``). SpUNet's convolution planes are a
    truncated normal of std 0.02 cut at two of it (flax's
    ``truncated_normal(0.02)``) and its ``final_bias`` zero. A module with a
    ``draw_parameters(generator)`` method draws the parameters it owns
    itself (the ViT's sincos ``pos_embed`` and ``cls_token``, MultiViT's
    global tokens, the learned position table). Batch norms keep scale 1,
    bias 0 and their running statistics."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, SpUNet):
            for name, p in mod.named_parameters(recurse=False):
                if name == "final_bias":
                    p.zero_()
                else:
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
            continue
        if hasattr(mod, "draw_parameters"):
            mod.draw_parameters(generator)
            continue
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            w = mod.weight
            fan_in = (w.shape[0] * w.shape[2] if isinstance(mod, nn.ConvTranspose1d)
                      else w[0].numel())
            w.copy_(normal(w.shape, 1.0 / math.sqrt(fan_in)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(mod.weight.shape[1])))
        elif not isinstance(mod, (MaskedBatchNorm, GroupedBNReluMax)):
            for p in mod.parameters(recurse=False):
                p.copy_(normal(p.shape, 1.0))


def build_flagship(hidden_dim=512, npoints=2048, nsample=16, chunk=100,
                   enc_layers=4, dec_layers=7, ffn=32, action_dim=7,
                   qpos_dim=9, goal_dim=3, nhead=8, seed=0, dropout=0.1,
                   freeze_backbone=False, pre_sample=False,
                   attention_impl="oneshot", backbone="pointnet", spunet=None,
                   use_mask=False, bg_ratio=0.0,
                   device: Union[str, torch.device] = "cuda") -> ACTPCD:
    """ACTPCD over PointNet (``backbone="pointnet"``) or SpUNet
    (``"spunet"``, its widths overridden by the ``spunet`` dict), weights
    from ``torch.Generator().manual_seed(seed)``, on ``device`` in eval
    mode; ``dropout`` is the transformers' rate.

    With ``pre_sample`` the backbone's per-token features are the
    transformer's tokens: PointNet's final linear maps them to
    ``hidden_dim`` below its published width of 512, and SpUNet's final
    1x1 convolution maps them to ``hidden_dim`` (the configs'
    ``num_classes: 512``). With ``use_mask`` FPS draws ``1 - bg_ratio`` of
    the tokens from the foreground (the cloud's ``mask``) and the rest from
    the background."""
    if backbone == "pointnet":
        net = PointNet(in_channels=6, num_classes=(
            hidden_dim if pre_sample and hidden_dim != WIDTHS[-1] else 0))
    elif backbone == "spunet":
        net = SpUNet(in_channels=6, num_classes=hidden_dim if pre_sample else 0,
                     **(spunet or {}))
    else:
        raise ValueError(f"backbone {backbone!r}: 'pointnet' or 'spunet'")
    transformer, encoder = _act_head(hidden_dim, enc_layers, dec_layers, ffn, nhead, dropout,
                                     attention_impl)
    policy = ACTPCD(
        backbone=net, transformer=transformer, encoder=encoder,
        hidden_dim=hidden_dim, num_queries=chunk,
        action_dim=action_dim, qpos_dim=qpos_dim, goal_cond_dim=goal_dim,
        kl_weight=10.0, pcd_nsample=nsample, pcd_npoints=npoints,
        freeze_backbone=freeze_backbone, pre_sample=pre_sample, use_mask=use_mask,
        bg_ratio=bg_ratio,
    )
    init_parameters(policy, torch.Generator().manual_seed(seed))
    return policy.to(device).eval()


def build_batch(batch_size=2, n_points=4096, chunk=100, action_dim=7,
                qpos_dim=9, goal_dim=3, seed=0, with_actions=True) -> dict:
    """Synthetic padded point-cloud batch in the collate layout, numpy.

    Row 0 is full, the others hold a random number of valid points, each in
    Morton order. ``with_actions=False`` drops ``actions`` and ``is_pad``: a
    serving request (the other arrays are unchanged)."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(batch_size, n_points, 3) * 0.4 - 0.2).astype(np.float32)
    color = rng.rand(batch_size, n_points, 3).astype(np.float32)
    counts = np.full((batch_size,), n_points, np.int32)
    counts[1:] = rng.randint(max(1, n_points // 2), n_points, batch_size - 1)
    valid = np.arange(n_points)[None] < counts[:, None]
    for b in range(batch_size):
        c = counts[b]
        order = morton_order(coord[b, :c])
        coord[b, :c] = coord[b, :c][order]
        color[b, :c] = color[b, :c][order]
    batch = {
        "qpos": rng.randn(batch_size, qpos_dim).astype(np.float32),
        "actions": rng.randn(batch_size, chunk, action_dim).astype(np.float32),
        "is_pad": np.arange(chunk)[None].repeat(batch_size, 0) >= chunk - 5,
        "goal_cond": rng.randn(batch_size, goal_dim).astype(np.float32),
        "pcds": {
            "coord": coord,
            "feat": np.concatenate([color, coord], -1),
            "valid": valid,
        },
    }
    if not with_actions:
        del batch["actions"], batch["is_pad"]
    return batch


def _scene_voxels(rng: np.random.RandomState, side: int) -> np.ndarray:
    """(V, 3) unique voxels of a table-top scene on a grid of ``side``
    voxels an axis: the table's top (z = 0) and the faces of three boxes
    standing on it."""
    surf = [np.stack(np.meshgrid(np.arange(side), np.arange(side), [0], indexing="ij"),
                     -1).reshape(-1, 3)]
    for _ in range(3):
        lo = rng.randint(0, side * 3 // 4, 2)
        size = rng.randint(side // 10, side // 4, 3)
        x, y, z = (np.arange(lo[0], min(lo[0] + size[0], side)),
                   np.arange(lo[1], min(lo[1] + size[1], side)), np.arange(1, size[2] + 1))
        for a, b, c in ((x, y, [z[-1]]), (x, [y[0], y[-1]], z), ([x[0], x[-1]], y, z)):
            surf.append(np.stack(np.meshgrid(a, b, c, indexing="ij"), -1).reshape(-1, 3))
    return np.unique(np.concatenate(surf), axis=0).astype(np.int32)


def build_grid_batch(batch_size=2, n_points=12800, valid_range=None, chunk=100, action_dim=7,
                     qpos_dim=9, goal_dim=3, seed=0, side=None,
                     with_actions=True) -> dict:
    """A batch in the collate layout, numpy, its clouds padded to
    ``n_points`` and grid-sampled at ``GRID_SIZE``: each valid point one
    voxel of a table-top scene (:func:`_scene_voxels`; unique in its cloud),
    its ``coord`` inside its voxel, ``grid_coord`` the voxel shifted to start
    at 0 as ``GridSamplePCD`` leaves it, ``feat`` = [color, coord]. Each
    cloud holds a count of valid points drawn from ``valid_range``
    (inclusive; default the top 3% below ``n_points``), in Morton order;
    ``qpos``, ``goal_cond``, ``actions`` and ``is_pad`` as :func:`build_batch`
    makes them. ``side`` (voxels an axis) defaults to what holds
    ``n_points``."""
    rng = np.random.RandomState(seed)
    lo, hi = valid_range or (n_points - n_points * 3 // 100, n_points)
    counts = rng.randint(lo, hi + 1, batch_size)
    side = side or int(math.ceil(math.sqrt(n_points))) + 2
    coord = np.zeros((batch_size, n_points, 3), np.float32)
    grid = np.zeros((batch_size, n_points, 3), np.int32)
    color = np.zeros((batch_size, n_points, 3), np.float32)
    for b, c in enumerate(counts):
        voxels = _scene_voxels(rng, side)
        if len(voxels) < c:
            raise ValueError(f"a scene of side {side} holds {len(voxels)} voxels, not {c}")
        vox = voxels[rng.choice(len(voxels), c, replace=False)]
        xyz = ((vox + rng.rand(c, 3)) * GRID_SIZE - GRID_SIZE * side / 2).astype(np.float32)
        order = morton_order(xyz)
        vox, xyz = vox[order], xyz[order]
        coord[b, :c], grid[b, :c] = xyz, vox - vox.min(0)
        color[b, :c] = rng.rand(c, 3)
    valid = np.arange(n_points)[None] < counts[:, None]
    batch = build_batch(batch_size, n_points=8, chunk=chunk, action_dim=action_dim,
                        qpos_dim=qpos_dim, goal_dim=goal_dim, seed=seed,
                        with_actions=with_actions)
    batch["pcds"] = {"coord": coord, "grid_coord": grid,
                     "feat": np.concatenate([color, coord], -1), "valid": valid}
    return batch


def _act_head(hidden_dim, enc_layers, dec_layers, ffn, nhead, dropout, attention_impl="oneshot"):
    """The ACT configs' transformer and CVAE posterior encoder."""
    return (Transformer(d_model=hidden_dim, nhead=nhead, num_encoder_layers=enc_layers,
                        num_decoder_layers=dec_layers, dim_feedforward=ffn, dropout=dropout,
                        normalize_before=False, return_intermediate_dec=True,
                        attention_impl=attention_impl),
            TransformerEncoder(d_model=hidden_dim, nhead=8, dim_feedforward=ffn,
                               num_layers=enc_layers, dropout=dropout))


def image_backbone(backbone: str, channels: int, backbone_kw=None) -> nn.Module:
    """ResNet-50, ViT-B/16 or the MultiViT-B trunk (RGB-D) of ``channels``
    input channels, ``backbone_kw`` overriding their arguments."""
    kw = dict(backbone_kw or {})
    if backbone == "resnet":
        return ResNetTorchVision(**{"resnet_model": "resnet50", "channels": channels, **kw})
    if backbone == "vit":
        return ViT(**{"model_name": "vit_base_patch16", "channels": channels, **kw})
    if backbone == "multivit":
        if channels != 4:
            raise ValueError(f"MultiViT takes RGB-D (4 channels), not {channels}")
        return MultiViTModel(**kw)
    raise ValueError(f"backbone {backbone!r}: 'resnet', 'vit' or 'multivit'")


def build_image_policy(backbone="resnet", channels=3, hidden_dim=512, chunk=100, enc_layers=4,
                       dec_layers=7, ffn=32, action_dim=7, qpos_dim=9, goal_dim=3, nhead=8,
                       seed=0, dropout=0.1, freeze_backbone=False, backbone_kw=None,
                       device: Union[str, torch.device] = "cuda") -> ACT:
    """ACT over images (module doc): ``backbone`` ``"resnet"`` (ResNet-50
    unless ``backbone_kw`` names another), ``"vit"`` (ViT-B/16) or
    ``"multivit"`` (4 channels only), weights from
    ``torch.Generator().manual_seed(seed)``, on ``device`` in eval mode."""
    net = image_backbone(backbone, channels, backbone_kw)
    transformer, encoder = _act_head(hidden_dim, enc_layers, dec_layers, ffn, nhead, dropout)
    policy = ACT(
        backbone=net, transformer=transformer, encoder=encoder, hidden_dim=hidden_dim,
        num_queries=chunk, action_dim=action_dim, qpos_dim=qpos_dim, goal_cond_dim=goal_dim,
        kl_weight=10.0, num_cameras=1, freeze_backbone=freeze_backbone,
        obs_feature_pos_embedding=PositionEmbeddingSine(hidden_dim // 2, normalize=True))
    init_parameters(policy, torch.Generator().manual_seed(seed))
    return policy.to(device).eval()


def build_state_policy(env_state_dim=16, hidden_dim=512, chunk=100, enc_layers=4, dec_layers=7,
                       ffn=32, action_dim=7, qpos_dim=9, goal_dim=3, nhead=8, seed=0,
                       dropout=0.1, attention_impl="oneshot",
                       device: Union[str, torch.device] = "cuda") -> ACT:
    """The state-only ACT (no backbone; ``configs/model/
    maniskill2_act_model.yaml``'s widths by default, with ``backbone:
    null``): robot state, ``env_state`` of ``env_state_dim`` and the goal
    as the encoder's tokens, weights from ``torch.Generator().manual_seed(
    seed)``, on ``device`` in eval mode."""
    transformer, encoder = _act_head(hidden_dim, enc_layers, dec_layers, ffn, nhead, dropout,
                                     attention_impl)
    policy = ACT(
        backbone=None, transformer=transformer, encoder=encoder, hidden_dim=hidden_dim,
        num_queries=chunk, action_dim=action_dim, qpos_dim=qpos_dim, goal_cond_dim=goal_dim,
        env_state_dim=env_state_dim, kl_weight=10.0)
    init_parameters(policy, torch.Generator().manual_seed(seed))
    return policy.to(device).eval()


def build_state_batch(batch_size=2, env_state_dim=16, chunk=100, action_dim=7, qpos_dim=9,
                      goal_dim=3, seed=0, with_actions=True) -> dict:
    """A state-only batch, numpy: ``env_state`` (B, env_state_dim) beside
    :func:`build_batch`'s ``qpos``, ``goal_cond``, ``actions`` and
    ``is_pad``."""
    batch = build_batch(batch_size, n_points=8, chunk=chunk, action_dim=action_dim,
                        qpos_dim=qpos_dim, goal_dim=goal_dim, seed=seed,
                        with_actions=with_actions)
    del batch["pcds"]
    batch["env_state"] = np.random.RandomState(seed + 2).randn(
        batch_size, env_state_dim).astype(np.float32)
    return batch


def build_image_batch(batch_size=2, side=128, channels=3, chunk=100, action_dim=7, qpos_dim=9,
                      goal_dim=3, seed=0, with_actions=True) -> dict:
    """A batch of one camera's (B, 1, side, side, channels) images, numpy,
    scaled as the datasets scale them: RGB in [0, 1), depth in metres over
    1.024 (mm / 2^10, up to 2), a pointmap's coordinates in [-0.2, 0.2);
    ``channels`` 1 is depth, 3 RGB, 4 RGB-D, 6 a pointmap's colours and
    coordinates. ``qpos``, ``goal_cond``, ``actions`` and ``is_pad`` as
    :func:`build_batch` makes them."""
    rng = np.random.RandomState(seed + 1)
    shape = (batch_size, 1, side, side)
    rgb = rng.rand(*shape, 3).astype(np.float32)
    depth = (rng.rand(*shape, 1) * 2).astype(np.float32)
    xyz = (rng.rand(*shape, 3) * 0.4 - 0.2).astype(np.float32)
    parts = {1: [depth], 3: [rgb], 4: [rgb, depth], 6: [rgb, xyz]}
    if channels not in parts:
        raise ValueError(f"channels {channels}: 1, 3, 4 or 6")
    batch = build_batch(batch_size, n_points=8, chunk=chunk, action_dim=action_dim,
                        qpos_dim=qpos_dim, goal_dim=goal_dim, seed=seed,
                        with_actions=with_actions)
    del batch["pcds"]
    batch["image"] = np.concatenate(parts[channels], axis=-1)
    return batch


def build_dp_policy(npoints=2048, nsample=16, hidden_dim=96, projector_channels=(96, 128, 128),
                    num_classes=96, horizon=16, n_action_steps=8, n_obs_steps=2,
                    num_train_timesteps=100, num_inference_steps=100,
                    diffusion_step_embed_dim=128, down_dims=(512, 1024, 2048), kernel_size=5,
                    n_groups=8, pre_sample=False, seed=0, normalizer=None,
                    device: Union[str, torch.device] = "cuda") -> DiffusionUnetImagePolicy:
    """The Diffusion Policy of ``scratch_pointnet_pcd`` (module doc; the
    defaults are its widths), weights from
    ``torch.Generator().manual_seed(seed)``, on ``device`` in eval mode.
    ``normalizer`` is set on the policy (None: the identity)."""
    encoder = PCDObsEncoder(
        shape_meta=DP_SHAPE_META, pcd_model=PointNet(in_channels=6, num_classes=num_classes),
        n_obs_step=n_obs_steps, pcd_nsample=nsample, pcd_npoints=npoints,
        pcd_hidden_dim=hidden_dim, projector_layers=1,
        projector_channels=list(projector_channels), pre_sample=pre_sample)
    policy = DiffusionUnetImagePolicy(
        shape_meta=DP_SHAPE_META,
        noise_scheduler=DDPMScheduler(
            num_train_timesteps=num_train_timesteps, beta_start=0.0001, beta_end=0.02,
            beta_schedule="squaredcos_cap_v2", clip_sample=True, prediction_type="epsilon"),
        obs_encoder=encoder, horizon=horizon, n_action_steps=n_action_steps,
        n_obs_steps=n_obs_steps, num_inference_steps=num_inference_steps,
        diffusion_step_embed_dim=diffusion_step_embed_dim, down_dims=tuple(down_dims),
        kernel_size=kernel_size, n_groups=n_groups, cond_predict_scale=True,
        normalizer=normalizer)
    init_parameters(policy, torch.Generator().manual_seed(seed))
    return policy.to(device).eval()


def build_dp_batch(batch_size=2, n_obs_steps=2, n_points=4096, horizon=16, action_dim=7,
                   qpos_dim=9, goal_dim=3, seed=0, with_actions=True) -> dict:
    """A Diffusion Policy batch in the collate layout, numpy: ``obs.qpos``
    (B, horizon, qpos_dim), ``obs.pcds`` of B * n_obs_steps clouds (sample
    by sample) padded to ``n_points`` as :func:`build_batch` makes them
    (cloud 0 full, the others a random number of valid points, each in
    Morton order), ``goal.task_emb`` and, unless ``with_actions`` is False
    (a serving request), ``action`` (B, horizon, action_dim)."""
    rng = np.random.RandomState(seed)
    clouds = build_batch(batch_size * n_obs_steps, n_points, seed=seed, with_actions=False)
    batch = {
        "obs": {"qpos": rng.randn(batch_size, horizon, qpos_dim).astype(np.float32),
                "pcds": clouds["pcds"]},
        "action": rng.randn(batch_size, horizon, action_dim).astype(np.float32),
        "goal": {"task_emb": rng.randn(batch_size, goal_dim).astype(np.float32)},
    }
    if not with_actions:
        del batch["action"]
    return batch


def image_dp_shape_meta(channels: int = 3, cameras=("base_camera",), side: int = 128,
                        qpos_dim: int = 9, action_dim: int = 7, goal_dim: int = 3) -> dict:
    """The image DP's ``shape_meta``: each camera's ``<camera>_rgb`` (3
    channels, or a pointmap's 6) and, for depth-only (1) and RGB-D (4), its
    ``<camera>_depth``; ``qpos``; the goal's ``task_emb``."""
    if channels not in (1, 3, 4, 6):
        raise ValueError(f"channels {channels}: 1, 3, 4 or 6")
    obs = {}
    for cam in cameras:
        obs[f"{cam}_rgb"] = {"shape": [side, side, 6 if channels == 6 else 3], "type": "rgb"}
        if channels in (1, 4):
            obs[f"{cam}_depth"] = {"shape": [side, side, 1], "type": "depth"}
    obs["qpos"] = {"shape": [qpos_dim], "type": "low_dim"}
    return {"action": {"shape": [action_dim]}, "obs": obs,
            "goal": {"task_emb": {"shape": [goal_dim]}}}


def build_image_dp_policy(backbone="resnet", channels=3, share_rgb_model=True,
                          cameras=("base_camera",), horizon=16, n_action_steps=8, n_obs_steps=2,
                          num_train_timesteps=100, num_inference_steps=100,
                          diffusion_step_embed_dim=128, down_dims=(512, 1024, 2048),
                          kernel_size=5, n_groups=8, seed=0, normalizer=None, backbone_kw=None,
                          encoder_kw=None, device: Union[str, torch.device] = "cuda",
                          init_device: Union[str, torch.device, None] = None
                          ) -> DiffusionUnetImagePolicy:
    """The image Diffusion Policy (module doc; the defaults are the shipped
    widths), weights from ``torch.Generator().manual_seed(seed)``, on
    ``device`` in eval mode. ``normalizer`` is set on the policy (None: the
    identity). With ``init_device`` the policy is built and drawn there,
    from a generator of that device seeded alike (other values than the
    CPU's): for widths the host would draw slowly, such as per-key image
    models that do not pool (several GB of condition weights)."""
    with torch.device(init_device) if init_device is not None else contextlib.nullcontext():
        shape_meta = image_dp_shape_meta(channels, cameras)
        pool = {"avg_pool": True} if backbone == "resnet" else {}  # the configs' ResNets pool
        encoder = MultiImageObsEncoder(**{
            "shape_meta": shape_meta,
            "rgb_model": image_backbone(backbone, channels, {**pool, **(backbone_kw or {})}),
            "resize_shape": (256, 256), "crop_shape": (224, 224), "random_crop": False,
            "share_rgb_model": share_rgb_model, "use_depth": channels in (1, 4),
            "only_depth": channels == 1, **(encoder_kw or {})})
        policy = DiffusionUnetImagePolicy(
            shape_meta=shape_meta,
            noise_scheduler=DDPMScheduler(
                num_train_timesteps=num_train_timesteps, beta_start=0.0001, beta_end=0.02,
                beta_schedule="squaredcos_cap_v2", clip_sample=True, prediction_type="epsilon"),
            obs_encoder=encoder, horizon=horizon, n_action_steps=n_action_steps,
            n_obs_steps=n_obs_steps, num_inference_steps=num_inference_steps,
            diffusion_step_embed_dim=diffusion_step_embed_dim, down_dims=tuple(down_dims),
            kernel_size=kernel_size, n_groups=n_groups, cond_predict_scale=True,
            normalizer=normalizer)
        init_parameters(policy, torch.Generator(init_device or "cpu").manual_seed(seed))
    return policy.to(device).eval()


def build_image_dp_batch(batch_size=2, side=128, channels=3, cameras=("base_camera",),
                         n_obs_steps=2, horizon=16, action_dim=7, qpos_dim=9, goal_dim=3, seed=0,
                         with_actions=True) -> dict:
    """An image DP batch, numpy: each camera's ``n_obs_steps`` frames
    (B, T, side, side, c) under the keys of :func:`image_dp_shape_meta`,
    scaled as :func:`build_image_batch` scales them (RGB in [0, 1), depth
    in [0, 2), a pointmap's coordinates in [-0.2, 0.2)); ``qpos`` (B,
    horizon, qpos_dim), ``goal.task_emb`` and, unless ``with_actions`` is
    False, ``action`` (B, horizon, action_dim)."""
    rng = np.random.RandomState(seed)
    shape = (batch_size, n_obs_steps, side, side)
    obs = {}
    for key, meta in image_dp_shape_meta(channels, cameras, side)["obs"].items():
        if meta["type"] == "depth":
            obs[key] = (rng.rand(*shape, 1) * 2).astype(np.float32)
        elif meta["type"] == "rgb":
            rgb = rng.rand(*shape, 3).astype(np.float32)
            xyz = (rng.rand(*shape, 3) * 0.4 - 0.2).astype(np.float32)
            obs[key] = np.concatenate([rgb, xyz], axis=-1) if channels == 6 else rgb
    obs["qpos"] = rng.randn(batch_size, horizon, qpos_dim).astype(np.float32)
    batch = {"obs": obs, "goal": {"task_emb": rng.randn(batch_size, goal_dim).astype(np.float32)}}
    if with_actions:
        batch["action"] = rng.randn(batch_size, horizon, action_dim).astype(np.float32)
    return batch


def write_rlbench_episodes(root: str, task_name: str = "close_jar", n_episodes: int = 3,
                           episode_len: int = 8, side: int = 16, stages=("train", "val"),
                           n_outside: int = 2, seed: int = 0) -> str:
    """Synthetic RLBench episodes in the processed layout that
    ``scripts/preprocess_rlbench.py`` writes (``<root>/<stage>/<task>/ep<i>.npy``:
    ``{"demo": [frame dicts], "task_goal": (512,)}``), numpy only, as
    ``tests/synth.make_synthetic_rlbench`` makes them: one front camera of
    ``side`` x ``side`` RGB, depth, mask and a cloud uniform in
    ``SCENE_BOUNDS`` but for ``n_outside`` points of its first row past the
    upper bounds (the crop drops them); the gripper inside the task's
    ``loc_bounds`` with a random unit quaternion. Returns ``root``."""
    import os

    rng = np.random.RandomState(seed)
    lo, hi = np.array(SCENE_BOUNDS[:3]), np.array(SCENE_BOUNDS[3:])
    pos_lo, pos_hi = (np.array(b) for b in loc_bounds[task_name])
    for stage in stages:
        out_dir = os.path.join(root, stage, task_name)
        os.makedirs(out_dir, exist_ok=True)
        for ep in range(n_episodes):
            demo = []
            for _ in range(episode_len):
                quat = rng.randn(4)
                pose = np.concatenate([rng.uniform(pos_lo, pos_hi), quat / np.linalg.norm(quat)])
                cloud = rng.uniform(lo, hi, (side, side, 3)).astype(np.float32)
                cloud[0, :n_outside] = hi + 1.0
                demo.append({
                    "ignore_collisions": float(rng.rand() > 0.5),
                    "front_rgb": rng.randint(0, 255, (side, side, 3)).astype(np.uint8),
                    "front_depth": rng.rand(side, side).astype(np.float32),
                    "front_point_cloud": cloud,
                    "front_mask": rng.randint(0, 250, (side, side)).astype(np.float32),
                    "gripper_pose": pose.astype(np.float32),
                    "gripper_open": float(rng.rand() > 0.5),
                })
            np.save(os.path.join(out_dir, f"ep{ep}.npy"),
                    dict(demo=demo, task_goal=rng.randn(512).astype(np.float32)),
                    allow_pickle=True)
    return root
