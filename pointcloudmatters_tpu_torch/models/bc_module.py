"""Behaviour-cloning task module (port of
``pointcloudmatters_tpu/models/bc_module.py``): ``select_model_batch``,
variable loading, ``predict``, the training side the ``Trainer`` drives
(optimizer, schedule and gradient accumulation from config dicts, the
step's random streams, the train-mode forward) and held-out-loss
validation (``run_validation``)."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from pointcloudmatters_tpu_torch.utils.metrics import Metrics
from pointcloudmatters_tpu_torch.utils.optimizer import GradientMean, build_optimizer
from pointcloudmatters_tpu_torch.utils.scheduler import build_scheduler

__all__ = ["select_model_batch", "to_device", "cast_floating", "BCModule"]

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


def to_device(tree, device: Union[str, torch.device], non_blocking: bool = False):
    """Nested dict of numpy arrays or tensors -> the same of tensors on
    ``device``; ``non_blocking`` copies from page-locked memory without
    waiting."""
    if isinstance(tree, Mapping):
        return {k: to_device(v, device, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.as_tensor(tree)
    return tree.to(device, non_blocking=non_blocking)


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict cast to ``dtype``; the others
    (indices, masks) unchanged (the JAX trainer's ``_cast_floating``)."""
    if isinstance(tree, Mapping):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


class BCModule:
    """Holds the policy on one device; serves actions and, once
    :meth:`configure_optimizers` ran, trains it (through ``Trainer``), and
    validates it by its held-out loss.

    ``optimizer`` and ``lr_scheduler`` are the JAX module's config dicts
    (``{"type": "AdamW", "lr": ...}``, ``{"scheduler": {"type":
    "OneCycleLR", ...}}``); ``val_metrics`` default to the mean held-out
    loss and ``best_val_metrics`` to its minimum over validations. Other
    keyword arguments (a task config's keys, such as ``env_id``) are kept in
    ``hparams``, and ``compile`` is accepted, as the JAX module accepts
    them."""

    # the step's random streams (JAX: vae sampling + dropout); "seed" seeds
    # the oneshot attention kernel's mask from the host
    train_rng_streams: tuple = ("vae", "dropout", "seed")
    # those drawn a row or an element at a time, each rank its own under data
    # parallelism ("bits": BitsDropout's, in a world of one "dropout" itself)
    rank_rng_streams: tuple = ("vae", "bits")

    def __init__(self, policy: nn.Module, device: Union[str, torch.device, None] = None,
                 optimizer: Optional[dict] = None, lr_scheduler: Optional[dict] = None,
                 train_metrics: Optional[Metrics] = None,
                 val_metrics: Optional[Metrics] = None,
                 best_val_metrics: Optional[Metrics] = None,
                 param_dicts: Optional[list] = None, compile: bool = False,
                 **hparams):
        if device is None:
            device = next(policy.parameters()).device
        self.device = torch.device(device)
        self.policy = policy.to(self.device).eval()
        self.optimizer_cfg = dict(optimizer or {"type": "AdamW", "lr": 1e-4})
        self.lr_scheduler_cfg = lr_scheduler
        self.param_dicts = param_dicts
        # the config's other keys, kept as the JAX module keeps them
        self.hparams = dict(hparams)
        self.compile = compile
        self.train_metrics = train_metrics or Metrics(
            ["MeanMetric"] * 3, ["loss", "action_loss", "kl_loss"],
            ["train/loss", "train/action_loss", "train/kl_loss"])
        self.val_metrics = val_metrics or Metrics(["MeanMetric"], ["loss"], ["val/loss"])
        self.best_val_metrics = best_val_metrics or Metrics(
            ["MinMetric"], ["val/loss"], ["val/loss_best"])
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler = None
        self.gradient_clip_val: Optional[float] = None
        self.gradient_mean: Optional[GradientMean] = None
        self.seed = 0  # seeds the step's random streams (make_rngs)
        self._extras: dict = {}

    @property
    def train_metric_keys(self) -> list[str]:
        return self.train_metrics.input_keys

    @property
    def val_metric_keys(self) -> list[str]:
        return [k for k in self.val_metrics.input_keys if k != "mean_success"]

    def setup_module(self, trainer) -> None:
        """What the module takes from the trainer and its datamodule before
        ``fit`` or ``validate`` restores a checkpoint (the JAX module's
        ``setup_module``); nothing here."""

    def to(self, device: Union[str, torch.device]) -> "BCModule":
        """The policy moved to ``device``; build the optimizer after."""
        self.device = torch.device(device)
        self.policy.to(self.device)
        return self

    def load_variables(self, variables: Mapping) -> None:
        """Load JAX ``variables`` (params and batch_stats) into the policy."""
        state = flax_to_torch(variables, self.policy)
        self.policy.load_state_dict(state, strict=True)

    def configure_optimizers(self, total_steps: int,
                             gradient_clip_val: Optional[float] = None,
                             accumulate_grad_batches: int = 1,
                             schedule_transform=None) -> None:
        """Optimizer and schedule over ``total_steps`` optimizer steps
        (the JAX ``configure_optimizers``), with the keyword-matched
        ``param_dicts`` groups; a global-norm clip of the gradients when
        ``gradient_clip_val`` is set; with ``accumulate_grad_batches`` k > 1
        the clip and the optimizer act on the mean gradient of every k
        micro-batches (``optax.MultiSteps`` around the clip and the
        optimizer, as there). ``schedule_transform`` wraps the learning
        rate's schedule (the SWA callback's; it gets None without a
        scheduler config); beta1's cycle stays as built. A new optimizer
        starts from a fresh state."""
        self.optimizer = build_optimizer(self.optimizer_cfg, self.policy,
                                         param_dicts=self.param_dicts)
        sched_cfg = None
        if self.lr_scheduler_cfg:
            sched_cfg = self.lr_scheduler_cfg.get("scheduler", self.lr_scheduler_cfg)
        self.scheduler = build_scheduler(self.optimizer, sched_cfg, total_steps,
                                         schedule_transform=schedule_transform)
        self.gradient_clip_val = gradient_clip_val
        self.gradient_mean = (GradientMean(accumulate_grad_batches)
                              if accumulate_grad_batches > 1 else None)

    def make_rngs(self, seed: int, rank: int = 0, world_size: int = 1,
                   step: int = 0) -> dict[str, torch.Generator]:
        """One generator per stream of ``train_rng_streams``, ``"bits"``
        and ``"mask"``, on the policy's device (``"seed"`` on the CPU).

        Under GSPMD every draw is one global draw: a mask shared over the
        batch is shared across the devices, and a row's draws are its own.
        So ``"dropout"`` (the dense attention's mask) and ``"seed"`` (the
        attention kernels' mask seeds) are seeded from ``seed`` alone, alike
        on every rank, and the ``rank_rng_streams`` (the CVAE noise and
        ``BitsDropout``'s bits) from ``(seed, rank)``, and ``step``, the
        optimizer steps a resumed run starts from. A world of one draws as
        the single-device trainer: ``"bits"`` is the ``"dropout"``
        generator itself. Where the streams hold no ``"mask"`` (ACT's), an
        MAE backbone's masking, drawn a row at a time, takes the ``"vae"``
        generator (JAX draws it from a stream of its own)."""
        n = len(self.train_rng_streams)

        def generator(name: str, s: int) -> torch.Generator:
            return torch.Generator(device="cpu" if name == "seed" else self.device).manual_seed(s)

        rngs = {name: generator(name, seed * n + i)
                for i, name in enumerate(self.train_rng_streams)}
        if world_size == 1:
            rngs["bits"] = rngs["dropout"]
        else:
            for i, name in enumerate(self.rank_rng_streams):
                entropy = np.random.SeedSequence(seed % 2 ** 63, spawn_key=(rank, i, step))
                rngs[name] = generator(name, int(entropy.generate_state(1, np.uint64)[0]))
        if "mask" not in rngs:  # MAE's masking draws a row at a time, as the CVAE noise
            rngs["mask"] = rngs["vae"]
        return rngs

    def forward_train(self, batch: dict, rngs: Mapping,
                      compute_dtype: Optional[torch.dtype] = None) -> dict:
        """The train-mode forward over a batch of model inputs (and
        collate bookkeeping, which is dropped); returns the policy's dict
        with ``loss``, ``action_loss`` and ``kl_loss``.

        With ``compute_dtype`` (bf16 mixed precision) the forward runs on
        copies of the floating parameters and batch arrays in that type,
        made by differentiable casts, so gradients reach the f32 parameters
        in f32; batch-norm running statistics stay f32 buffers (the JAX
        trainer's step, ``trainer.py:249-266``)."""
        batch = to_device(select_model_batch(batch), self.device)
        if compute_dtype is None:
            return self.policy(batch, train=True, rngs=rngs)
        params = {name: p.to(compute_dtype) if p.is_floating_point() else p
                  for name, p in self.policy.named_parameters()}
        return torch.func.functional_call(
            self.policy, params, (cast_floating(batch, compute_dtype),),
            {"train": True, "rngs": rngs})

    @torch.inference_mode()
    def apply_eval(self, batch: dict) -> dict:
        """The eval-mode forward of the f32 parameters over a batch with
        actions: the policy's dict with the held-out ``loss`` (no dropout,
        the CVAE latent at its mean, running statistics)."""
        return self.policy(to_device(select_model_batch(batch), self.device, non_blocking=True),
                           train=False)

    def run_validation(self, trainer, datamodule) -> dict:
        """Held-out-loss validation (JAX ``bc_module.py:209-235``): the mean
        of ``val_metric_keys`` over ``trainer.limit_val_batches`` batches of
        the validation loader, then the best-so-far trackers; floats.
        ``{}`` without a validation loader or over a ``DummyDataset``.

        Under data parallelism a batch's value is the global batch's, its
        ranks' means weighted by their rows (a loader may give ranks
        ragged blocks), the same on every rank; each rank gives it to the
        metrics with weight 1 / W, whose ``compute`` sums their states over
        the ranks."""
        loader = datamodule.val_dataloader()
        if loader is None or not self._has_real_val_data(loader):
            return {}
        from pointcloudmatters_tpu_torch.trainer import _batch_size_of, _limit

        self.val_metrics.reset()
        n_val = _limit(len(loader), trainer.limit_val_batches)
        world = dist.get_world_size()
        for i, batch in enumerate(loader):
            if i >= n_val:
                break
            out = self.apply_eval(batch)
            values = {k: out[k].float() for k in self.val_metric_keys if k in out}
            if world > 1 and values:
                # the global batch's mean: each rank's mean weighted by its rows
                rows = float(_batch_size_of(batch))
                summed = torch.stack([*values.values(), torch.ones((), device=self.device)])
                summed = summed * rows
                dist.all_reduce_([summed])
                values = dict(zip(values, summed[:-1] / summed[-1]))
            self.val_metrics.update(values, 1.0 / world)
        out = self.val_metrics.compute()
        self.best_val_metrics.update(out, 1.0 / world)
        out.update(self.best_val_metrics.compute())
        return {k: float(v) for k, v in out.items()}

    @staticmethod
    def _has_real_val_data(loader) -> bool:
        ds = getattr(loader, "dataset", None)
        return not type(ds).__name__.startswith("Dummy")

    def state_dict_extras(self) -> dict:
        """What a checkpoint keeps beside the weights and the optimizer
        (the JAX module's ``extras``)."""
        return dict(self._extras)

    def load_state_dict_extras(self, extras: dict) -> None:
        self._extras.update(extras or {})

    @torch.inference_mode()
    def predict(self, obs: dict) -> torch.Tensor:
        """Actions (B, num_queries, action_dim) for a batch of observations
        without actions; arrays may be numpy or tensors on any device."""
        batch = to_device(select_model_batch(obs), self.device)
        return self.policy(batch, train=False)["a_hat"]
