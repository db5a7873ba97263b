"""The ManiSkill2 and RLBench task modules (port of
``pointcloudmatters_tpu/models/maniskill2_modules.py``): ACT's, the
flagship's module (``configs/model/maniskill2_act_pcd_model.yaml:1``), the
Diffusion Policy's (``configs/model/maniskill2_diffusion_policy_model.yaml:1``),
and RLBench's two (``configs/model/rlbench_*_model.yaml``).

A ManiSkill2 module validates by closed-loop rollouts in the simulator
(``envs/rollout.py``), scored by ``mean_success`` (and ``mean_grasp`` /
``mean_align`` for the staged PegInsertion variants), the policy served
from the module's device. The env comes from ``env_factory(module)`` where
one is given, else from ManiSkill2. Only a failure to build the env falls
back to the held-out loss, with the JAX module's warning (``{}`` over the
configs' validation ``DummyDataset``, as in JAX); an error inside an
episode propagates. The RLBench modules validate by the held-out loss.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.envs.rollout import (
    make_maniskill2_env,
    run_maniskill2_dp_rollouts,
    run_maniskill2_rollouts,
)
from pointcloudmatters_tpu_torch.models.bc_module import BCModule, select_model_batch, to_device
from pointcloudmatters_tpu_torch.utils.flax_to_torch import arrays_to_tensors
from pointcloudmatters_tpu_torch.utils.metrics import Metrics
from pointcloudmatters_tpu_torch.utils.normalizer import LinearNormalizer

__all__ = ["ManiSkill2ACTBCModule", "ManiSkill2DiffusionPolicyBCModule", "RLBenchACTBCModule",
           "RLBenchDiffusionPolicyBCModule"]

log = logging.getLogger(__name__)


def _reward_figure_logger(trainer):
    """Each episode's reward curve to the loggers that take figures
    (TensorBoard; reference `maniskill2_act_bc_module.py:298-304`); None
    without one, or without matplotlib."""
    figure_loggers = [lg for lg in getattr(trainer.logger, "loggers", [])
                      if hasattr(lg, "log_figure")]
    if not figure_loggers:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    def on_episode_end(idx, success, rewards):
        fig = plt.figure()
        ax = fig.add_subplot(111)
        ax.plot(rewards)
        ax.set_title(f"episode {idx} success={success}")
        for lg in figure_loggers:
            lg.log_figure(f"val/rewards_{idx}", fig, trainer.global_step)
        plt.close(fig)

    return on_episode_end


def _host_actions(actions: torch.Tensor) -> np.ndarray:
    return actions.float().cpu().numpy()


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

    def _make_env(self, dataset):
        if self.env_factory is not None:
            return self.env_factory(self)
        env_kwargs = getattr(dataset, "env_kwargs", {}) or {}
        # rt_* only matter under the ray tracer; the reference passes its
        # render config always (`maniskill2_act_bc_module.py:103-108`)
        return make_maniskill2_env(
            self.env_id, obs_mode=self.obs_mode,
            control_mode=env_kwargs.get("control_mode", "pd_ee_delta_pose"),
            shader_dir=self.shader_dir, rt_samples_per_pixel=self.rt_samples_per_pixel,
            rt_use_denoiser=self.rt_use_denoiser, use_stereo_depth=self.use_stereo_depth)

    def _rollout_env(self, trainer, datamodule):
        """(dataset, episodes, env) of a rollout validation; the env None
        where there are no episodes, or where the simulator cannot be built
        (then with the JAX module's warning)."""
        from pointcloudmatters_tpu_torch.trainer import _limit

        dataset = datamodule.data_train
        val_loader = datamodule.val_dataloader()
        n_episodes = _limit(len(val_loader.dataset) if val_loader is not None else 0,
                            trainer.limit_val_batches)
        if n_episodes <= 0:
            return dataset, 0, None
        try:
            env = self._make_env(dataset)
        except Exception as e:  # the simulator is not available here
            log.warning(f"ManiSkill2 simulator unavailable ({type(e).__name__}: {e}); "
                        "falling back to held-out-loss validation")
            return dataset, n_episodes, None
        return dataset, n_episodes, env

    def _rollout_metrics(self, metrics: dict) -> dict:
        self.val_metrics.reset()
        self.val_metrics.update(metrics)
        out = self.val_metrics.compute()
        for extra in ("mean_grasp", "mean_align"):
            if extra in metrics:
                out[f"val/{extra}"] = metrics[extra]
        self.best_val_metrics.update(out)
        out.update(self.best_val_metrics.compute())
        return {k: float(v) for k, v in out.items()}

    def run_validation(self, trainer, datamodule) -> dict:
        """``num_envs`` envs (a pool of threads beyond one) roll the policy
        over the validation set's length of episodes (at most
        ``limit_val_batches``); the policy is served one env at a time."""
        dataset, n_episodes, env = self._rollout_env(trainer, datamodule)
        if n_episodes <= 0:
            return {}
        if env is None:
            return super().run_validation(trainer, datamodule)
        lock = threading.Lock()

        def predict(data_dict):
            with lock:
                return _host_actions(self.predict(data_dict))

        try:
            metrics = run_maniskill2_rollouts(
                predict=predict, dataset=dataset, env=env, env_id=self.env_id or "",
                n_episodes=n_episodes, action_dim=self.policy.action_dim,
                num_queries=self.policy.num_queries, temporal_agg=self.temporal_agg,
                pad_multiple=getattr(datamodule, "pad_multiple", 512),
                on_episode_end=_reward_figure_logger(trainer),
                env_factory=(lambda: self._make_env(dataset)) if self.num_envs > 1 else None,
                num_envs=self.num_envs)
        finally:
            env.close()
        return self._rollout_metrics(metrics)


class RLBenchACTBCModule(BCModule):
    """RLBench's ACT module: held-out-loss validation
    (`rlbench_act_bc_module.py:88-110`), actions given, so the head's
    rotation stays 6D as in training."""


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

    def run_validation(self, trainer, datamodule) -> dict:
        dataset, n_episodes, env = self._rollout_env(trainer, datamodule)
        if n_episodes <= 0:
            return {}
        if env is None:
            return BCModule.run_validation(self, trainer, datamodule)
        generator = torch.Generator(device=self.device).manual_seed(
            getattr(trainer, "seed", None) or 0)

        def predict(data_dict):
            return _host_actions(self.predict(data_dict, generator))

        try:
            metrics = run_maniskill2_dp_rollouts(
                predict=predict, dataset=dataset, env=env, env_id=self.env_id or "",
                n_episodes=n_episodes, n_obs_steps=self.policy.n_obs_steps,
                pad_multiple=getattr(datamodule, "pad_multiple", 512),
                on_episode_end=_reward_figure_logger(trainer))
        finally:
            env.close()
        return self._rollout_metrics(metrics)


class RLBenchDiffusionPolicyBCModule(ManiSkill2DiffusionPolicyBCModule):
    """RLBench's Diffusion Policy module: held-out-loss validation
    (`rlbench_dp_bc_module.py:17,46-50`)."""

    def run_validation(self, trainer, datamodule) -> dict:
        return BCModule.run_validation(self, trainer, datamodule)
