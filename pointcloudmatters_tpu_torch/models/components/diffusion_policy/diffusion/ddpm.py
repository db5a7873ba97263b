"""DDPM noise scheduler (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/diffusion/ddpm.py``).

The tables are f32 numpy constants computed from f64 betas; ``step`` takes
its noise as an argument (drawn by the caller from its generator) and gates
it out at t = 0. Supported: ``beta_schedule`` linear, scaled_linear and
squaredcos_cap_v2; ``prediction_type`` epsilon and sample; ``variance_type``
fixed_small; ``clip_sample``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["DDPMScheduler"]


def _betas(num_steps: int, beta_start: float, beta_end: float, schedule: str) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps, dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.array([min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), 0.999)
                         for i in range(num_steps)], np.float64)
    raise NotImplementedError(schedule)


@dataclass(frozen=True)
class DDPMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    variance_type: str = "fixed_small"
    _tables: dict = field(default_factory=dict, compare=False, repr=False)

    def _table(self, name: str) -> np.ndarray:
        if "betas" not in self._tables:
            betas = _betas(self.num_train_timesteps, self.beta_start, self.beta_end,
                           self.beta_schedule)
            alphas = 1.0 - betas
            self._tables.update(betas=betas.astype(np.float32),
                                alphas=alphas.astype(np.float32),
                                alphas_cumprod=np.cumprod(alphas).astype(np.float32))
        return self._tables[name]

    @property
    def config(self) -> "DDPMScheduler":
        """The scheduler itself (diffusers' ``scheduler.config`` reads)."""
        return self

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return self._table("alphas_cumprod")

    def _abar(self, device) -> torch.Tensor:
        """``alphas_cumprod`` on ``device``, copied there once (a training
        step then copies nothing from the host)."""
        key = ("alphas_cumprod", torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(self.alphas_cumprod).to(device)
        return self._tables[key]

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps for (B,)
        integer ``timesteps``, mixed in f32 and returned in the sample's
        type."""
        abar = self._abar(sample.device)[timesteps.to(torch.long)]
        abar = abar.reshape(abar.shape + (1,) * (sample.ndim - abar.ndim))
        out = (torch.sqrt(abar) * sample.to(torch.float32)
               + torch.sqrt(1.0 - abar) * noise.to(torch.float32))
        return out.to(sample.dtype)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The descending timestep grid (diffusers' arange striding)."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()
        return ts[::-1].copy().astype(np.int32)

    def step(self, model_output: torch.Tensor, timestep: int, prev_timestep: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One reverse step x_t -> x_{t-1} (diffusers' DDPM, variance
        ``fixed_small``); ``noise`` is standard normal of the sample's shape,
        gated out at t = 0. The step is computed in f32, as JAX promotes
        against the schedule's f32 constants, and the result is in the
        sample's type."""
        dtype = sample.dtype
        sample, model_output = sample.to(torch.float32), model_output.to(torch.float32)
        abar = self.alphas_cumprod
        abar_t = torch.tensor(abar[timestep], dtype=torch.float32)
        abar_prev = torch.tensor(abar[prev_timestep] if prev_timestep >= 0 else 1.0,
                                 dtype=torch.float32)
        beta_t = 1.0 - abar_t / abar_prev
        alpha_t = 1.0 - beta_t
        if self.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(1.0 - abar_t) * model_output) / torch.sqrt(abar_t)
        elif self.prediction_type == "sample":
            x0 = model_output
        else:
            raise ValueError(f"Unsupported prediction type {self.prediction_type}")
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
        mean = coef_x0 * x0 + coef_xt * sample
        if self.variance_type != "fixed_small":
            raise NotImplementedError(self.variance_type)
        variance = torch.clamp(beta_t * (1.0 - abar_prev) / (1.0 - abar_t), min=1e-20)
        add = torch.sqrt(variance) if timestep > 0 else torch.zeros((), dtype=torch.float32)
        return (mean + add * noise.to(torch.float32)).to(dtype)
