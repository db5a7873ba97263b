"""ACT over images and point clouds, and their RLBench heads (port of
``pointcloudmatters_tpu/models/components/act/act.py:59-455``).

Call protocol as in JAX: ``policy(data_dict, train=..., rngs=...)`` returns
a new dict with ``a_hat`` (B, num_queries, action_dim) and ``is_pad_hat``
merged in, and when actions are present ``loss``, ``action_loss`` and
``kl_loss``. Without actions the CVAE latent is zero (JAX
``act.py:152-155``); with actions it comes from the posterior ``encoder``
over ``[CLS, qpos, actions]``, sampled in training and its mean otherwise.

``train=True`` needs ``rngs``, the step's random streams: ``"vae"`` (the
posterior noise), ``"dropout"``, ``"bits"`` and ``"mask"`` (an MAE
backbone's token masking, the ``"vae"`` generator itself; generators on
the batch's device, ``BCModule.make_rngs``) and ``"seed"`` (a CPU
generator seeding the oneshot attention kernel's mask).
``ACT`` embeds camera images (``data_dict["image"]``, (B, cameras, H, W,
C)) through an image backbone, ``ACTPCD`` point clouds; the state-only
path (no backbone) is not ported and raises ``NotImplementedError``.
``ACTRLBench`` and ``ACTRLBenchPCD`` act in gripper poses: sigmoid gripper
(and collision) channels, a 6D rotation in training that becomes a
quaternion otherwise, and a loss weighting the xyz channels.

The module runs in the type of its parameters and inputs: f32, or bf16
when the trainer's mixed precision casts both (``trainer.py``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.act.positional_encoding import (
    coord_embedding_sine,
)
from pointcloudmatters_tpu_torch.models.components.act.transformer import (
    Transformer,
    TransformerEncoder,
)
from pointcloudmatters_tpu_torch.models.components.loss.misc import (
    KLDivergence,
    build_action_loss,
    masked_action_loss,
)
from pointcloudmatters_tpu_torch.models.components.nn_utils import (
    GroupedBNReluMax,
    get_sinusoid_encoding_table,
    reparametrize,
)
from pointcloudmatters_tpu_torch.ops.pointops import (
    farthest_point_sampling_padded,
    knn_query_padded,
)
from pointcloudmatters_tpu_torch.utils.rotation_conversions import (
    matrix_to_quaternion,
    rotation_6d_to_matrix,
)

__all__ = ["ACT", "ACTPCD", "ACTRLBench", "ACTRLBenchPCD"]


class ACT(nn.Module):
    """Action Chunking Transformer over camera images, and the parameters
    and CVAE / decoder / head stages that the point-cloud variant shares.
    Parameter names are the JAX module's.

    The image backbone maps (B, H, W, C) images to (B, h, w, C') features or
    pooled (B, C') ones and has a ``num_channels`` property; each camera's
    cells become tokens through ``input_proj``, placed by
    ``obs_feature_pos_embedding``. With ``freeze_backbone`` no gradient
    reaches the backbone, which still runs in the step's mode (its batch
    statistics move in training) and whose parameters the optimizer still
    decays, as in JAX. A backbone whose ``masks_tokens`` is true (MAE's
    ViT) draws its training mask from ``rngs["mask"]``. ``feature_mode`` is
    the configs' key, not read, as in JAX."""

    def __init__(self, backbone: Optional[nn.Module], transformer: Transformer,
                 encoder: Optional[TransformerEncoder], hidden_dim: int,
                 num_queries: int, action_dim: int = 8, qpos_dim: int = 9,
                 latent_dim: int = 32, action_loss=None, kl_weight: float = 20.0,
                 goal_cond_dim: int = 0, num_cameras: int = 0, env_state_dim: int = 0,
                 klloss=None, freeze_backbone: bool = False,
                 obs_feature_pos_embedding: Optional[nn.Module] = None,
                 feature_mode: str = "cls"):
        super().__init__()
        if backbone is None:
            raise NotImplementedError(
                "the state-only ACT path is not ported yet; pass a backbone"
            )
        D = hidden_dim
        n_add = 2 + int(goal_cond_dim > 0)
        self.backbone = backbone
        self.transformer = transformer
        self.encoder = encoder
        self.hidden_dim = hidden_dim
        self.num_queries = num_queries
        self.action_dim = action_dim
        self.qpos_dim = qpos_dim
        self.latent_dim = latent_dim
        self.kl_weight = kl_weight
        self.goal_cond_dim = goal_cond_dim
        self.num_cameras = num_cameras
        # the state width, which the JAX module keeps and never reads
        self.env_state_dim = env_state_dim
        self.freeze_backbone = freeze_backbone
        self.feature_mode = feature_mode
        self._klloss = klloss if callable(klloss) else KLDivergence()
        self._action_loss = build_action_loss(action_loss)
        self.input_proj = nn.Linear(backbone.num_channels, D)
        self.obs_feature_pos_embedding = obs_feature_pos_embedding
        self.input_proj_robot_state = nn.Linear(qpos_dim, D)
        self.cls_embed = nn.Parameter(torch.zeros(1, D))
        self.encoder_action_proj = nn.Linear(action_dim, D)
        self.encoder_joint_proj = nn.Linear(qpos_dim, D)
        self.latent_proj = nn.Linear(D, latent_dim * 2)
        if goal_cond_dim > 0:
            self.proj_goal_cond_emb = nn.Linear(goal_cond_dim, D)
        self.action_head = nn.Linear(D, action_dim)
        self.is_pad_head = nn.Linear(D, 1)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, D))
        self.latent_out_proj = nn.Linear(latent_dim, D)
        self.additional_pos_embed = nn.Parameter(torch.zeros(n_add, D))
        # positions of the posterior's [CLS, qpos, actions] tokens; a
        # constant kept on the model's device, outside the state dict
        self.register_buffer(
            "encoder_pos", get_sinusoid_encoding_table(2 + num_queries, D),
            persistent=False)

    def forward_encoder(self, data_dict: dict, train: bool,
                        rngs: Optional[Mapping] = None) -> dict:
        """CVAE latent (JAX ``act.py:121-160``): the posterior over
        ``[CLS, qpos, actions]`` with the ``is_pad`` key mask, sampled with
        ``rngs["vae"]`` in training and its mean otherwise; without actions
        a zero latent."""
        qpos = data_dict["qpos"]
        actions = data_dict.get("actions")
        bs = qpos.shape[0]
        if actions is None:
            latent_sample = qpos.new_zeros((bs, self.latent_dim))
            return dict(data_dict, mu=None, logvar=None,
                        latent_input=self.latent_out_proj(latent_sample),
                        is_training=False)
        is_pad = data_dict["is_pad"].to(torch.bool)
        action_embed = self.encoder_action_proj(actions)  # (B, nq, D)
        qpos_embed = self.encoder_joint_proj(qpos)[:, None, :]  # (B, 1, D)
        cls = self.cls_embed[None].expand(bs, 1, self.hidden_dim).to(action_embed.dtype)
        tokens = torch.cat([cls, qpos_embed, action_embed], dim=1)
        pad_mask = torch.cat([is_pad.new_zeros((bs, 2)), is_pad], dim=1)
        out = self.encoder(tokens, pos=self.encoder_pos, key_padding_mask=pad_mask,
                           deterministic=not train, rngs=rngs)
        latent_info = self.latent_proj(out[:, 0])  # the [CLS] output only
        mu = latent_info[:, :self.latent_dim]
        logvar = latent_info[:, self.latent_dim:]
        latent_sample = reparametrize(mu, logvar, rngs["vae"]) if train else mu
        return dict(data_dict, mu=mu, logvar=logvar,
                    latent_input=self.latent_out_proj(latent_sample),
                    is_training=True)

    def _goal_embed(self, data_dict: dict) -> Optional[torch.Tensor]:
        if self.goal_cond_dim <= 0:
            return None
        goal = data_dict["goal_cond"]
        if goal.ndim > 2:
            goal = goal.reshape(goal.shape[0], -1)
        return self.proj_goal_cond_emb(goal)

    def _proprio_input(self, data_dict: dict) -> torch.Tensor:
        """``[robot state, goal]`` tokens (B, 1 or 2, D)."""
        proprio = self.input_proj_robot_state(data_dict["qpos"])[:, None, :]
        goal_cond = self._goal_embed(data_dict)
        if goal_cond is not None:
            proprio = torch.cat([proprio, goal_cond[:, None, :]], dim=1)
        return proprio

    def forward_obs_embed(self, data_dict: dict, train: bool,
                          rngs: Optional[Mapping] = None) -> dict:
        """Each camera's backbone features as tokens (JAX ``act.py:173-
        198``): a pooled feature is one cell (B, 1, 1, C); the cells are
        projected by ``input_proj`` and placed by
        ``obs_feature_pos_embedding`` (one table for the batch)."""
        image = data_dict["image"]  # (B, cameras, H, W, C)
        masks = train and getattr(self.backbone, "masks_tokens", False)
        kw = {"generator": rngs["mask"]} if masks else {}
        tokens, positions = [], []
        for cam in range(self.num_cameras):
            feats = self.backbone(image[:, cam], train=train, **kw)
            if self.freeze_backbone:
                feats = feats.detach()
            if feats.ndim == 2:
                feats = feats[:, None, None, :]
            positions.append(self.obs_feature_pos_embedding(feats))
            tokens.append(self.input_proj(feats).reshape(feats.shape[0], -1, self.hidden_dim))
        return dict(data_dict, src=torch.cat(tokens, dim=1), pos=torch.cat(positions, dim=1),
                    proprio_input=self._proprio_input(data_dict))

    def _decode(self, data_dict: dict, train: bool,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        hs = self.transformer(
            data_dict["src"], self.query_embed, pos=data_dict["pos"],
            latent_input=data_dict["latent_input"],
            proprio_input=data_dict["proprio_input"],
            additional_pos_embed=(
                self.additional_pos_embed
                if data_dict["latent_input"] is not None else None
            ),
            deterministic=not train, rngs=rngs,
        )
        return hs[0]  # first decoder layer's intermediate, the reference quirk

    def forward_decoder(self, data_dict: dict, train: bool,
                        rngs: Optional[Mapping] = None) -> dict:
        hs = self._decode(data_dict, train, rngs)
        return dict(data_dict, a_hat=self.action_head(hs),
                    is_pad_hat=self.is_pad_head(hs))

    def forward_loss(self, data_dict: dict) -> dict:
        """``loss = action_loss + kl * kl_weight`` (JAX ``act.py:238-249``)."""
        total_kld = self._klloss(data_dict["mu"], data_dict["logvar"])
        action_loss = masked_action_loss(
            self._action_loss, data_dict["a_hat"], data_dict["actions"],
            data_dict["is_pad"].to(torch.bool),
        )
        return dict(data_dict, action_loss=action_loss, kl_loss=total_kld,
                    loss=action_loss + total_kld * self.kl_weight)

    def forward(self, data_dict: dict, train: bool = False,
                rngs: Optional[Mapping] = None) -> dict:
        if train and rngs is None:
            raise ValueError("ACT training needs rngs ('vae', 'dropout', 'bits', 'seed', 'mask')")
        data_dict = self.forward_encoder(data_dict, train, rngs)
        data_dict = self.forward_obs_embed(data_dict, train, rngs)
        data_dict = self.forward_decoder(data_dict, train, rngs)
        if not data_dict["is_training"]:
            return data_dict
        return self.forward_loss(data_dict)


class ACTPCD(ACT):
    """ACT over point-cloud tokens: backbone features of the whole cloud,
    FPS to ``pcd_npoints`` token centres, kNN groups of ``pcd_nsample``,
    and the ``GroupedBNReluMax`` token builder. The backbone maps
    ``{"coord", "feat", "valid"}`` to (B, N, C) per-point features and has a
    ``num_channels`` property."""

    def __init__(self, backbone: nn.Module, transformer: Transformer,
                 encoder: Optional[TransformerEncoder], hidden_dim: int,
                 num_queries: int, pcd_nsample: int = 16,
                 pcd_npoints: int = 1024, use_mask: bool = False,
                 pre_sample: bool = False, **kwargs):
        super().__init__(backbone, transformer, encoder, hidden_dim,
                         num_queries, **kwargs)
        # the tokens come from the point-cloud builder (JAX act.py:276-278)
        self.input_proj = self.obs_feature_pos_embedding = None
        if use_mask:
            raise NotImplementedError("ACTPCD use_mask is not ported yet")
        self.pcd_nsample = pcd_nsample
        self.pcd_npoints = pcd_npoints
        self.pre_sample = pre_sample
        # pre_sample projects the raw cloud to the backbone's input width
        # (JAX act.py:279-283), else the backbone's features to hidden_dim
        proj_dim = backbone.in_channels if pre_sample else hidden_dim
        feat_dim = backbone.in_channels if pre_sample else backbone.num_channels
        self.pcd_linear = nn.Linear(3 + feat_dim, proj_dim, bias=False)
        self.pcd_bn = GroupedBNReluMax(proj_dim)

    def pcd_sampling(self, coord: torch.Tensor, feat: torch.Tensor,
                     valid: torch.Tensor, train: bool = False,
                     feat_is_data: bool = False):
        """-> (new_xyz (B, m, 3), tokens (B, m, proj_dim), idx (B, m)).

        ``pcd_linear`` is bias-free, so projecting each gathered neighbour
        ``[xyz[nn] - new_xyz, feat[nn]]`` equals
        ``pcd_linear([xyz, feat])[nn] - pcd_linear([new_xyz, 0])``: the N
        source points are projected once (JAX ``act.py:305-350``). With
        ``feat_is_data`` (a raw ``pre_sample`` cloud, a frozen backbone's
        features) the builder may take the data-source kernels, as
        ``GroupedBNReluMax.resolve_impl`` decides; learned features stay on
        the plain chain (their backward needs the dense dg)."""
        idx = farthest_point_sampling_padded(coord, valid, self.pcd_npoints)
        new_xyz = torch.gather(
            coord, 1, idx.to(torch.long)[..., None].expand(-1, -1, 3))
        nn_idx, _ = knn_query_padded(new_xyz, coord, valid, self.pcd_nsample)
        zeros_f = feat.new_zeros(new_xyz.shape[:-1] + (feat.shape[-1],))
        src_cat = torch.cat([coord, feat], dim=-1)
        h = self.pcd_linear(torch.cat([new_xyz, zeros_f], dim=-1))
        impl = GroupedBNReluMax.resolve_impl(
            coord.shape[1], nn_idx.shape[1], nn_idx.shape[2], h.shape[-1],
            h.dtype, h.device,
        ) if feat_is_data else "xla"
        if impl == "fused":
            W = self.pcd_linear.weight.t().to(h.dtype)  # (Cin, D)
            x = self.pcd_bn(None, h, nn_idx, use_running_average=not train,
                            src=src_cat.detach(), W=W, impl="fused_data")
        else:
            g = self.pcd_linear(src_cat)
            x = self.pcd_bn(g, h, nn_idx, use_running_average=not train)
        return new_xyz, x, idx

    def forward_pcd_embed(self, pcd_dict: dict, train: bool):
        coord = pcd_dict["coord"]
        valid = pcd_dict["valid"].to(torch.bool)
        if self.pre_sample:
            # raw cloud -> tokens -> backbone over the sampled tokens
            # (JAX act.py:357-373)
            new_xyz, feat, idx = self.pcd_sampling(
                coord, pcd_dict["feat"], valid, train=train, feat_is_data=True)
            sampled = dict(pcd_dict, coord=new_xyz, feat=feat,
                           valid=torch.ones(idx.shape, dtype=torch.bool,
                                            device=idx.device))
            if "grid_coord" in pcd_dict:
                grid = pcd_dict["grid_coord"]
                sampled["grid_coord"] = torch.gather(
                    grid, 1, idx.to(torch.long)[..., None].expand(-1, -1, grid.shape[-1]))
            features = self.backbone(sampled, train=train)
            coords_out = new_xyz
        else:
            features = self.backbone(pcd_dict, train=train)
            if self.freeze_backbone:
                features = features.detach()
            coords_out, features, _ = self.pcd_sampling(
                coord, features, valid, train=train,
                feat_is_data=self.freeze_backbone)
        return features, coord_embedding_sine(coords_out, self.hidden_dim)

    def forward_obs_embed(self, data_dict: dict, train: bool,
                          rngs: Optional[Mapping] = None) -> dict:
        src, pos = self.forward_pcd_embed(data_dict["pcds"], train)
        return dict(data_dict, src=src, pos=pos, proprio_input=self._proprio_input(data_dict))


class _RLBenchHeadMixin:
    """The gripper-pose head of the RLBench variants (JAX ``act.py:399-440``):
    the action is ``[xyz, rotation, gripper (, collision)]``, its last one or
    two channels through a sigmoid; the rotation is 6D while ``is_training``
    (actions given) and a quaternion otherwise. The loss weights each xyz
    element by ``position_loss_weight`` before the mean over every element,
    padded slots included."""

    def __init__(self, *args, rot_type: str = "6d", collision: bool = False,
                 position_loss_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.rot_type = rot_type
        self.collision = collision
        self.position_loss_weight = position_loss_weight

    def forward_decoder(self, data_dict: dict, train: bool,
                        rngs: Optional[Mapping] = None) -> dict:
        hs = self._decode(data_dict, train, rngs)
        a_hat = self.action_head(hs)
        position = a_hat[..., :3]
        if self.collision:
            gripper = torch.sigmoid(a_hat[..., -2:])
            rot = a_hat[..., 3:-2]
        else:
            gripper = torch.sigmoid(a_hat[..., -1:])
            rot = a_hat[..., 3:-1]
        if not data_dict["is_training"]:
            if self.rot_type != "6d":
                raise NotImplementedError(self.rot_type)
            rot = matrix_to_quaternion(rotation_6d_to_matrix(rot))
        return dict(data_dict, a_hat=torch.cat([position, rot, gripper], dim=-1),
                    is_pad_hat=self.is_pad_head(hs))

    def forward_loss(self, data_dict: dict) -> dict:
        total_kld = self._klloss(data_dict["mu"], data_dict["logvar"])
        a_hat = data_dict["a_hat"]
        # an f32 weight, as JAX's jnp.ones: a bf16 loss is weighted in f32
        weight = torch.ones(a_hat.shape[-1], device=a_hat.device)
        weight[:3] = self.position_loss_weight

        def weighted(pred, target):
            return self._action_loss(pred, target) * weight

        action_loss = masked_action_loss(weighted, a_hat, data_dict["actions"],
                                         data_dict["is_pad"].to(torch.bool))
        return dict(data_dict, action_loss=action_loss, kl_loss=total_kld,
                    loss=action_loss + total_kld * self.kl_weight)


class ACTRLBench(_RLBenchHeadMixin, ACT):
    """ACT over camera images with the RLBench head (JAX ``act.py:443``)."""


class ACTRLBenchPCD(_RLBenchHeadMixin, ACTPCD):
    """ACT over point clouds with the RLBench head (JAX ``act.py:451``)."""
