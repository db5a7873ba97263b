"""The ManiSkill2 task modules (port of
``pointcloudmatters_tpu/models/maniskill2_modules.py:58-305``): ACT's, the
flagship's module (``configs/model/maniskill2_act_pcd_model.yaml:1``), and
the Diffusion Policy's (``configs/model/maniskill2_diffusion_policy_model.yaml:1``).

Its validation is closed-loop rollouts in the ManiSkill2 simulator, scored
by ``mean_success``. Rollouts are not ported yet (``ROADMAP.md`` §1 item
12): without a simulator, validation falls back to the held-out loss with
the JAX module's warning, which gives ``{}`` over the configs' validation
``DummyDataset``, as in JAX; an ``env_factory`` raises.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from pointcloudmatters_tpu_torch.models.bc_module import BCModule, select_model_batch, to_device
from pointcloudmatters_tpu_torch.utils.flax_to_torch import arrays_to_tensors
from pointcloudmatters_tpu_torch.utils.metrics import Metrics
from pointcloudmatters_tpu_torch.utils.normalizer import LinearNormalizer

__all__ = ["ManiSkill2ACTBCModule", "ManiSkill2DiffusionPolicyBCModule"]

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


class ManiSkill2DiffusionPolicyBCModule(ManiSkill2ACTBCModule):
    """The Diffusion Policy's task module: the dataset's ``LinearNormalizer``
    set on the policy before training (and kept in the checkpoint's extras),
    ``loss`` alone as a train metric, and the streams ``"noise"`` (the
    loss's noise and timesteps, drawn a row at a time: each rank its own
    under data parallelism), ``"dropout"``, ``"crop"`` and ``"mask"``.
    Validation as ``ManiSkill2ACTBCModule``'s. The held-out loss draws from
    streams seeded 0 for every batch, and ``predict`` from the generator it
    is given."""

    train_rng_streams = ("noise", "dropout", "crop", "mask")
    rank_rng_streams = ("noise",)

    def __init__(self, policy, optimizer=None, lr_scheduler=None, train_metrics=None,
                 **hparams):
        super().__init__(
            policy=policy, optimizer=optimizer, lr_scheduler=lr_scheduler,
            train_metrics=train_metrics or Metrics(["MeanMetric"], ["loss"], ["train/loss"]),
            **hparams)

    def setup_module(self, trainer) -> None:
        """The training set's normalizer onto a policy that has none."""
        dataset = getattr(getattr(trainer, "datamodule", None), "data_train", None)
        if self.policy.normalizer is None and hasattr(dataset, "get_normalizer"):
            normalizer = dataset.get_normalizer()
            self.policy.normalizer = normalizer
            self._extras["normalizer"] = arrays_to_tensors(normalizer.state_dict())
            log.info("wired the dataset's LinearNormalizer into the policy")

    def load_state_dict_extras(self, extras: dict) -> None:
        super().load_state_dict_extras(extras)
        if "normalizer" in self._extras:
            self._extras["normalizer"] = arrays_to_tensors(self._extras["normalizer"])
            self.policy.normalizer = LinearNormalizer.from_state_dict(self._extras["normalizer"])

    @torch.inference_mode()
    def apply_eval(self, batch: dict) -> dict:
        # the streams bound from seed 0 for every batch, as JAX's apply_eval
        # binds them from PRNGKey(0)
        return self.policy(to_device(select_model_batch(batch), self.device, non_blocking=True),
                           train=False, rngs=self.make_rngs(0))

    @torch.inference_mode()
    def predict(self, obs: dict, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The executed actions (B, n_action_steps, action_dim) of the whole
        reverse chain, drawn from ``generator`` (on the module's device; a
        generator seeded with ``seed`` if None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
        batch = to_device(select_model_batch(obs), self.device)
        return self.policy(batch, train=False, rngs={"sample": generator})["a_hat"]
