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

``build_dp_policy()`` is the Diffusion Policy over point clouds of
``configs/exp_maniskill2_diffusion_policy`` (``scratch_pointnet_pcd``,
PickCube-v0): PointNet to 96 channels, FPS to 2048 tokens, kNN k=16, the
projector [96, 128, 128], two observation frames, horizon 16, 8 executed
steps, a DDPM of 100 steps (``squaredcos_cap_v2``), and the
ConditionalUnet1D with step embedding 128, ``down_dims`` [512, 1024, 2048],
kernel 5, 8 groups and FiLM scales: 255,687,303 UNet parameters.
``build_dp_batch()`` is a batch of its data in the collate layout.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.data.collate import morton_order
from pointcloudmatters_tpu_torch.models.components.act.act import ACTPCD
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.ddpm import (
    DDPMScheduler,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion_unet_image_policy import (  # noqa: E501
    DiffusionUnetImagePolicy,
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

__all__ = ["build_flagship", "build_batch", "build_dp_policy", "build_dp_batch",
           "init_parameters", "morton_order", "DP_SHAPE_META"]

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
    ``query_embed``) standard normal. Batch norms keep scale 1, bias 0 and
    their running statistics."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            w = mod.weight
            fan_in = (w.shape[0] * w.shape[2] if isinstance(mod, nn.ConvTranspose1d)
                      else w[0].numel())
            w.copy_(normal(w.shape, 1.0 / math.sqrt(fan_in)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif not isinstance(mod, (MaskedBatchNorm, GroupedBNReluMax)):
            for p in mod.parameters(recurse=False):
                p.copy_(normal(p.shape, 1.0))


def build_flagship(hidden_dim=512, npoints=2048, nsample=16, chunk=100,
                   enc_layers=4, dec_layers=7, ffn=32, action_dim=7,
                   qpos_dim=9, goal_dim=3, nhead=8, seed=0, dropout=0.1,
                   freeze_backbone=False, pre_sample=False,
                   attention_impl="oneshot",
                   device: Union[str, torch.device] = "cuda") -> ACTPCD:
    """ACTPCD + PointNet, weights from ``torch.Generator().manual_seed(seed)``,
    on ``device`` in eval mode; ``dropout`` is the transformers' rate.

    With ``pre_sample`` the PointNet's per-token features are the
    transformer's tokens, so below its published width of 512 a final
    linear maps them to ``hidden_dim``."""
    policy = ACTPCD(
        backbone=PointNet(in_channels=6, num_classes=(
            hidden_dim if pre_sample and hidden_dim != WIDTHS[-1] else 0)),
        transformer=Transformer(
            d_model=hidden_dim, nhead=nhead, num_encoder_layers=enc_layers,
            num_decoder_layers=dec_layers, dim_feedforward=ffn, dropout=dropout,
            normalize_before=False, return_intermediate_dec=True,
            attention_impl=attention_impl,
        ),
        encoder=TransformerEncoder(
            d_model=hidden_dim, nhead=8, dim_feedforward=ffn,
            num_layers=enc_layers, dropout=dropout,
        ),
        hidden_dim=hidden_dim, num_queries=chunk,
        action_dim=action_dim, qpos_dim=qpos_dim, goal_cond_dim=goal_dim,
        kl_weight=10.0, pcd_nsample=nsample, pcd_npoints=npoints,
        freeze_backbone=freeze_backbone, pre_sample=pre_sample,
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
