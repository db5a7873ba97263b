"""The ManiSkill2 ACT task module (port of
``pointcloudmatters_tpu/models/maniskill2_modules.py:58-185``), the
flagship's module (``configs/model/maniskill2_act_pcd_model.yaml:1``).

Its validation is closed-loop rollouts in the ManiSkill2 simulator, scored
by ``mean_success``. Rollouts are not ported yet (``ROADMAP.md`` §1 item
12): without a simulator, validation falls back to the held-out loss with
the JAX module's warning, which gives ``{}`` over the configs' validation
``DummyDataset``, as in JAX; an ``env_factory`` raises.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.utils.metrics import Metrics

__all__ = ["ManiSkill2ACTBCModule"]

log = logging.getLogger(__name__)


class ManiSkill2ACTBCModule(BCModule):
    """``BCModule`` with the ManiSkill2 rollout settings and the
    ``val/mean_success`` trackers (its mean, and its maximum over
    validations)."""

    def __init__(
        self,
        policy,
        optimizer=None,
        lr_scheduler=None,
        env_id: Optional[str] = None,
        obs_mode: str = "pointcloud",
        shader_dir: str = "ibl",
        rt_samples_per_pixel: int = 32,
        rt_use_denoiser: bool = True,
        use_stereo_depth: bool = False,
        temporal_agg: bool = True,
        num_envs: int = 1,
        env_factory: Optional[Callable] = None,
        train_metrics=None,
        val_metrics=None,
        best_val_metrics=None,
        **kwargs,
    ):
        super().__init__(
            policy=policy, optimizer=optimizer, lr_scheduler=lr_scheduler,
            train_metrics=train_metrics,
            val_metrics=val_metrics or Metrics(
                ["MeanMetric"], ["mean_success"], ["val/mean_success"]),
            best_val_metrics=best_val_metrics or Metrics(
                ["MaxMetric"], ["val/mean_success"], ["val/mean_success"]),
            **kwargs,
        )
        self.env_id = env_id
        self.obs_mode = obs_mode
        self.shader_dir = shader_dir
        self.rt_samples_per_pixel = rt_samples_per_pixel
        self.rt_use_denoiser = rt_use_denoiser
        self.use_stereo_depth = use_stereo_depth
        self.temporal_agg = temporal_agg
        self.num_envs = num_envs
        self.env_factory = env_factory

    @property
    def val_metric_keys(self) -> list[str]:
        return []  # rollout metrics come from the simulator, not the eval step

    def run_validation(self, trainer, datamodule) -> dict:
        from pointcloudmatters_tpu_torch.trainer import _limit

        val_loader = datamodule.val_dataloader()
        n_episodes = len(val_loader.dataset) if val_loader is not None else 0
        if _limit(n_episodes, trainer.limit_val_batches) <= 0:
            return {}
        if self.env_factory is not None:
            raise NotImplementedError(
                "ManiSkill2 simulator rollouts are not ported yet (ROADMAP.md §1 item 12)")
        log.warning("ManiSkill2 simulator unavailable (rollouts are not ported: ROADMAP.md "
                    "§1 item 12); falling back to held-out-loss validation")
        return super().run_validation(trainer, datamodule)
