"""The flagship model and synthetic batches of the port (port of
``__graft_entry__.build_flagship`` / ``build_batch``).

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
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.data.collate import morton_order
from pointcloudmatters_tpu_torch.models.components.act.act import ACTPCD
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

__all__ = ["build_flagship", "build_batch", "init_parameters", "morton_order"]


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw the weights the way the JAX modules initialise theirs, from
    ``generator`` (a CPU generator): linear weights normal with std
    1/sqrt(fan_in), biases zero, layer norms one/zero, the learned
    embeddings (parameters a module owns directly, such as ACT's
    ``query_embed``) standard normal. Batch norms keep scale 1, bias 0 and
    their running statistics."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(normal(mod.weight.shape, 1.0 / math.sqrt(mod.in_features)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
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
