"""Inpainting mask generators (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/diffusion/mask_generator.py``).

Functions of a shape and, for their random branches, a ``torch.Generator``
(on the device the masks are made on); no module state. The training path
uses ``LowdimMaskGenerator(fix_obs_steps=True, action_visible=False)``,
which draws nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["DummyMaskGenerator", "LowdimMaskGenerator", "KeypointMaskGenerator"]


def _device(generator: Optional[torch.Generator], device) -> torch.device:
    return torch.device(device if device is not None else
                        generator.device if generator is not None else "cpu")


class DummyMaskGenerator:
    def __call__(self, shape, generator: Optional[torch.Generator] = None, device=None):
        return torch.ones(shape, dtype=torch.bool, device=_device(generator, device))


class LowdimMaskGenerator:
    """True = conditioned (visible): the obs dims of the first
    ``max_n_obs_steps`` timesteps (with ``fix_obs_steps``, else a random
    count a row from ``generator``)."""

    def __init__(self, action_dim: int, obs_dim: int, max_n_obs_steps: int = 2,
                 fix_obs_steps: bool = True, action_visible: bool = False):
        self.action_dim = action_dim
        self.obs_dim = obs_dim
        self.max_n_obs_steps = max_n_obs_steps
        self.fix_obs_steps = fix_obs_steps
        self.action_visible = action_visible

    def __call__(self, shape, generator: Optional[torch.Generator] = None, device=None):
        B, T, D = shape
        assert D == self.action_dim + self.obs_dim, (D, self.action_dim, self.obs_dim)
        device = _device(generator, device)
        is_action_dim = (torch.arange(D, device=device) < self.action_dim).expand(shape)
        if self.fix_obs_steps:
            obs_steps = torch.full((B,), self.max_n_obs_steps, device=device)
        else:
            if generator is None:
                raise ValueError("fix_obs_steps=False needs a generator")
            obs_steps = torch.randint(1, self.max_n_obs_steps + 1, (B,), generator=generator,
                                      device=device)
        steps = torch.arange(T, device=device)[None, :]
        mask = (steps < obs_steps[:, None])[:, :, None] & ~is_action_dim
        if self.action_visible:
            action_steps = torch.clamp_min(obs_steps - 1, 0)
            mask = mask | ((steps < action_steps[:, None])[:, :, None] & is_action_dim)
        return mask


class KeypointMaskGenerator:
    """Keypoint dropout masking; the random parts draw from ``generator``."""

    def __init__(self, action_dim: int, keypoint_dim: int, max_n_obs_steps: int = 2,
                 fix_obs_steps: bool = True, keypoint_visible_rate: float = 0.7,
                 time_independent: bool = False, action_visible: bool = False,
                 context_dim: int = 0, n_context_steps: int = 1):
        self.action_dim = action_dim
        self.keypoint_dim = keypoint_dim
        self.max_n_obs_steps = max_n_obs_steps
        self.fix_obs_steps = fix_obs_steps
        self.keypoint_visible_rate = keypoint_visible_rate
        self.time_independent = time_independent
        self.action_visible = action_visible
        self.context_dim = context_dim
        self.n_context_steps = n_context_steps

    def __call__(self, shape, generator: Optional[torch.Generator] = None, device=None):
        B, T, D = shape
        device = _device(generator, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        n_keypoints = (D - self.action_dim - self.context_dim) // self.keypoint_dim
        dims = torch.arange(D, device=device)
        is_action = (dims < self.action_dim).expand(shape)
        is_context = ((dims >= self.action_dim)
                      & (dims < self.action_dim + self.context_dim)).expand(shape)
        is_obs = ~(is_action | is_context)
        if self.fix_obs_steps:
            obs_steps = torch.full((B,), self.max_n_obs_steps, device=device)
        else:
            obs_steps = torch.randint(1, self.max_n_obs_steps + 1, (B,), generator=generator,
                                      device=device)
        steps = torch.arange(T, device=device)[None, :]
        obs_mask = (steps < obs_steps[:, None])[:, :, None] & is_obs
        if self.time_independent:
            vis = torch.rand((B, T, n_keypoints), generator=generator, device=device)
        else:
            vis = torch.rand((B, 1, n_keypoints), generator=generator,
                             device=device).expand(B, T, n_keypoints)
        kp_visible = (vis < self.keypoint_visible_rate).repeat_interleave(
            self.keypoint_dim, dim=-1)
        pad = D - self.action_dim - self.context_dim - kp_visible.shape[-1]
        ones = torch.ones((B, T, self.action_dim + self.context_dim), dtype=torch.bool,
                          device=device)
        kp_full = torch.cat([ones, kp_visible,
                             torch.ones((B, T, pad), dtype=torch.bool, device=device)], dim=-1)
        obs_mask = obs_mask & kp_full
        context_mask = (steps < self.n_context_steps)[:, :, None] & is_context
        mask = obs_mask | context_mask
        if self.action_visible:
            action_steps = torch.clamp_min(obs_steps - 1, 0)
            mask = mask | ((steps < action_steps[:, None])[:, :, None] & is_action)
        return mask
