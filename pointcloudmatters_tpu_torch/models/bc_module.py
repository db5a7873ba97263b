"""Behaviour-cloning task module (port of
``pointcloudmatters_tpu/models/bc_module.py``), serving side:
``select_model_batch``, variable loading and ``predict``. Optimizers,
schedules and validation come with the training step."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Union

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch

__all__ = ["select_model_batch", "to_device", "BCModule"]

_MODEL_INPUT_KEYS = (
    "qpos", "actions", "is_pad", "goal_cond", "image", "env_state", "obs",
    "action", "goal",
)
_PCD_INPUT_KEYS = ("coord", "grid_coord", "feat", "valid", "mask", "color", "condition")


def select_model_batch(batch: dict) -> dict:
    """Strip collate bookkeeping (offsets, counts) down to model inputs."""
    out = {k: batch[k] for k in _MODEL_INPUT_KEYS if k in batch}
    if "pcds" in batch:
        out["pcds"] = {
            k: batch["pcds"][k] for k in _PCD_INPUT_KEYS if k in batch["pcds"]
        }
    if "obs" in batch and isinstance(batch["obs"], dict):
        obs = dict(batch["obs"])
        if "pcds" in obs:
            obs["pcds"] = {
                k: obs["pcds"][k] for k in _PCD_INPUT_KEYS if k in obs["pcds"]
            }
        out["obs"] = obs
    return out


def to_device(tree, device: Union[str, torch.device]):
    """Nested dict of numpy arrays or tensors -> the same of tensors on
    ``device``."""
    if isinstance(tree, Mapping):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return tree.to(device)


class BCModule:
    """Holds the policy on one device, in eval mode, and serves actions."""

    def __init__(self, policy: nn.Module, device: Union[str, torch.device, None] = None):
        if device is None:
            device = next(policy.parameters()).device
        self.device = torch.device(device)
        self.policy = policy.to(self.device).eval()

    def load_variables(self, variables: Mapping) -> None:
        """Load JAX ``variables`` (params and batch_stats) into the policy."""
        state = flax_to_torch(variables, self.policy.state_dict())
        self.policy.load_state_dict(state, strict=True)

    @torch.inference_mode()
    def predict(self, obs: dict) -> torch.Tensor:
        """Actions (B, num_queries, action_dim) for a batch of observations
        without actions; arrays may be numpy or tensors on any device."""
        batch = to_device(select_model_batch(obs), self.device)
        return self.policy(batch, train=False)["a_hat"]
