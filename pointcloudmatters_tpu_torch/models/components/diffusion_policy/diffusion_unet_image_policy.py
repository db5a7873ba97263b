"""Diffusion Policy: DDPM over normalized action trajectories (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/diffusion_unet_image_policy.py``).

Training adds noise at a random timestep and regresses it (epsilon
prediction, mean squared error under the inpainting loss mask); serving runs
the whole reverse chain, ``num_inference_steps`` UNet calls in a Python
loop.

Call protocol as in JAX: ``policy(data_dict, train=..., rngs=...)``. With
``"action"`` present it returns the dict with ``loss``, drawing the noise
and the timesteps from ``rngs["noise"]``; without, ``action``,
``action_pred`` and ``a_hat`` (the executed window), drawing the initial
trajectory and every step's noise from ``rngs["sample"]``. The image
encoder's random crops in training draw from ``rngs["crop"]``. The generators
are on the batch's device. All draws go through :func:`training_draws` and
:func:`sampling_noise`, so that a test can hand both packages the same
draws.

``normalizer`` is a ``LinearNormalizer`` (``utils/normalizer.py``) or None
(the identity); the task module sets it from the dataset. Its f32 constants
make the normalized ``qpos`` and ``action`` f32 whatever their type, so
under the trainer's ``"bf16-mixed"`` the point-cloud encoder runs in bf16 up
to the concatenation with ``qpos`` and the condition, the trajectory and the
UNet's products are f32 (on bf16-rounded weights), as in the JAX step. The
images, normalized by identity entries, are f32 too, and the image encoder's
backbone runs in f32 on bf16-rounded weights, as flax promotes them.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.conditional_unet1d import (  # noqa: E501
    ConditionalUnet1D,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.ddpm import (
    DDPMScheduler,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.mask_generator import (  # noqa: E501
    LowdimMaskGenerator,
)

__all__ = ["DiffusionUnetImagePolicy", "training_draws", "sampling_noise"]


def training_draws(generator: torch.Generator, shape, dtype: torch.dtype, batch: int,
                   num_train_timesteps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A training step's draws: standard normal noise of ``shape`` in
    ``dtype`` and ``batch`` int32 timesteps in [0, num_train_timesteps)."""
    noise = torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)
    timesteps = torch.randint(0, num_train_timesteps, (batch,), generator=generator,
                              device=generator.device, dtype=torch.int32)
    return noise, timesteps


def sampling_noise(generator: torch.Generator, shape, dtype: torch.dtype,
                   step: Optional[int]) -> torch.Tensor:
    """The sampling chain's draws: the initial trajectory (``step`` None)
    and the noise of reverse step ``step``, standard normal."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)


class DiffusionUnetImagePolicy(nn.Module):
    def __init__(self, shape_meta: Any, noise_scheduler: DDPMScheduler, obs_encoder: nn.Module,
                 horizon: int, n_action_steps: int, n_obs_steps: int,
                 num_inference_steps: Optional[int] = None, obs_as_global_cond: bool = True,
                 diffusion_step_embed_dim: int = 256, down_dims: Sequence[int] = (256, 512, 1024),
                 kernel_size: int = 5, n_groups: int = 8, cond_predict_scale: bool = True,
                 normalizer: Any = None):
        super().__init__()
        if not obs_as_global_cond:
            raise NotImplementedError("obs_as_global_cond=False")
        self.shape_meta = shape_meta
        self.noise_scheduler = noise_scheduler
        self.obs_encoder = obs_encoder
        self.horizon = horizon
        self.n_action_steps = n_action_steps
        self.n_obs_steps = n_obs_steps
        self.num_inference_steps = num_inference_steps
        self.normalizer = normalizer
        # the condition: each observation frame's features, and the goal's
        goal = shape_meta.get("goal") or {}
        goal_dim = math.prod(goal["task_emb"]["shape"]) if "task_emb" in goal else 0
        self.global_cond_dim = obs_encoder.feature_dim * n_obs_steps + goal_dim
        self.model = ConditionalUnet1D(
            input_dim=self.action_dim, local_cond_dim=None, global_cond_dim=self.global_cond_dim,
            diffusion_step_embed_dim=diffusion_step_embed_dim, down_dims=tuple(down_dims),
            kernel_size=kernel_size, n_groups=n_groups, cond_predict_scale=cond_predict_scale)
        self.mask_generator = LowdimMaskGenerator(
            action_dim=self.action_dim, obs_dim=0, max_n_obs_steps=n_obs_steps,
            fix_obs_steps=True, action_visible=False)

    @property
    def action_dim(self) -> int:
        shape = self.shape_meta["action"]["shape"]
        assert len(shape) == 1
        return int(shape[0])

    @property
    def num_queries(self) -> int:
        """The executed window (the rollout loop's name for it)."""
        return self.n_action_steps

    # -- normalization ---------------------------------------------------
    def _normalize_obs(self, obs: dict) -> dict:
        if self.normalizer is None:
            return dict(obs)
        return {k: self.normalizer[k].normalize(v) if k in self.normalizer else v
                for k, v in obs.items()}

    def _normalize_action(self, action):
        if self.normalizer is None or "action" not in self.normalizer:
            return action
        return self.normalizer["action"].normalize(action)

    def _unnormalize_action(self, action):
        if self.normalizer is None or "action" not in self.normalizer:
            return action
        return self.normalizer["action"].unnormalize(action)

    # -- conditioning ----------------------------------------------------
    def _global_cond(self, data_dict: dict, train: bool,
                     rngs: Optional[Mapping] = None) -> tuple[torch.Tensor, int]:
        """(B, global_cond_dim): the first ``n_obs_steps`` frames' features
        (the clouds already ``(B * To, N, ...)`` from the collate) and the
        goal's task embedding. ``rngs`` go on to the observation encoder
        (the image encoder's random crops draw from ``"crop"``)."""
        obs = dict(data_dict["obs"])
        pcds = obs.pop("pcds", None)
        nobs = self._normalize_obs(obs)
        To = self.n_obs_steps
        B = next(iter(nobs.values())).shape[0]
        this_nobs = {k: v[:, :To].reshape((B * To,) + tuple(v.shape[2:]))
                     for k, v in nobs.items()}
        if pcds is not None:
            this_nobs["pcds"] = pcds
        global_cond = self.obs_encoder(this_nobs, train=train, rngs=rngs).reshape(B, -1)
        goal = data_dict.get("goal")
        if goal is not None and "task_emb" in goal:
            global_cond = torch.cat([global_cond, goal["task_emb"].reshape(B, -1)], dim=-1)
        return global_cond, B

    # -- serving ---------------------------------------------------------
    def conditional_sample(self, cond_data: torch.Tensor, cond_mask: torch.Tensor,
                           global_cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        scheduler = self.noise_scheduler
        n_steps = self.num_inference_steps or scheduler.num_train_timesteps
        ts = scheduler.inference_timesteps(n_steps)
        ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
        traj = sampling_noise(generator, cond_data.shape, cond_data.dtype, None)
        for i, (t, t_prev) in enumerate(zip(ts.tolist(), ts_prev.tolist())):
            traj = torch.where(cond_mask, cond_data, traj)
            pred = self.model(traj, t, global_cond=global_cond)
            noise = sampling_noise(generator, traj.shape, torch.float32, i)
            traj = scheduler.step(pred, t, t_prev, traj, noise)
        return torch.where(cond_mask, cond_data, traj)

    def predict_action(self, data_dict: dict, generator: torch.Generator) -> dict:
        global_cond, B = self._global_cond(data_dict, train=False)
        shape = (B, self.horizon, self.action_dim)
        device = global_cond.device
        cond_data = torch.zeros(shape, dtype=torch.float32, device=device)
        cond_mask = torch.zeros(shape, dtype=torch.bool, device=device)
        nsample = self.conditional_sample(cond_data, cond_mask, global_cond, generator)
        action_pred = self._unnormalize_action(nsample[..., :self.action_dim])
        start = self.n_obs_steps - 1
        action = action_pred[:, start:start + self.n_action_steps]
        return dict(data_dict, action=action, action_pred=action_pred, a_hat=action,
                    is_training=False)

    # -- training --------------------------------------------------------
    def compute_loss(self, data_dict: dict, train: bool, rngs: Mapping) -> dict:
        global_cond, B = self._global_cond(data_dict, train=train, rngs=rngs)
        generator = rngs["noise"]
        trajectory = self._normalize_action(data_dict["action"])
        condition_mask = self.mask_generator(trajectory.shape, device=trajectory.device)
        noise, timesteps = training_draws(generator, trajectory.shape, trajectory.dtype, B,
                                          self.noise_scheduler.num_train_timesteps)
        noisy = self.noise_scheduler.add_noise(trajectory, noise, timesteps)
        noisy = torch.where(condition_mask, trajectory, noisy)
        pred = self.model(noisy, timesteps, global_cond=global_cond)
        pred_type = self.noise_scheduler.prediction_type
        if pred_type == "epsilon":
            target = noise
        elif pred_type == "sample":
            target = trajectory
        else:
            raise ValueError(f"Unsupported prediction type {pred_type}")
        loss = (pred - target) ** 2 * (~condition_mask).to(pred.dtype)
        return dict(data_dict, loss=loss.reshape(B, -1).mean(dim=-1).mean(), is_training=True)

    def forward(self, data_dict: dict, train: bool = False,
                rngs: Optional[Mapping] = None) -> dict:
        if "action" in data_dict:
            if rngs is None or "noise" not in rngs:
                raise ValueError("the diffusion loss needs rngs['noise']")
            return self.compute_loss(data_dict, train, rngs)
        if rngs is None or "sample" not in rngs:
            raise ValueError("diffusion sampling needs rngs['sample']")
        return self.predict_action(data_dict, rngs["sample"])
