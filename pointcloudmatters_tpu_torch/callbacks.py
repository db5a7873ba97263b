"""Trainer callbacks (port of ``pointcloudmatters_tpu/callbacks.py``), the
``configs/callbacks/*.yaml`` group: ModelCheckpoint (top-k on a monitored
metric, and ``save_last``), EarlyStopping, LearningRateMonitor,
ModelSummary, RichProgressBar (a log line an epoch) and DeviceStatsMonitor
(the card's memory in use). Checkpoints are written by
``Trainer.save_checkpoint``: a directory a checkpoint, as in JAX.

Under data parallelism every rank runs the callbacks on the same global
metrics, so ModelCheckpoint and EarlyStopping decide alike on every rank;
rank 0 alone writes and deletes files (``Trainer.save_checkpoint``), and
every rank holds the same ``best_model_path``.

``StochasticWeightAveraging`` (opt-in:
``configs/callbacks/stochastic_weight_averaging.yaml``, ``callbacks=
stochastic_weight_averaging``) wraps the learning rate's schedule, averages
the epoch-end parameters and swaps the average in, with refreshed batch-norm
statistics, when the fit ends.
"""

from __future__ import annotations

import math
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["Callback", "ModelCheckpoint", "EarlyStopping", "LearningRateMonitor",
           "ModelSummary", "RichProgressBar", "ProgressBar", "StochasticWeightAveraging",
           "DeviceStatsMonitor"]

log = RankedLogger(__name__, rank_zero_only=True)


class Callback:
    def setup(self, trainer, module) -> None:
        pass

    def on_fit_start(self, trainer, module) -> None:
        pass

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        pass

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        pass

    def on_fit_end(self, trainer, module) -> None:
        pass


_FMT_TOKEN = re.compile(r"\{([^{}:]+)(?::([^{}]+))?\}")


def _format_filename(pattern: str, metrics: dict, auto_insert: bool) -> str:
    """Fill "epoch={epoch:03d}-acc={val/acc:.3f}" patterns, whose keys may
    hold '/' (``str.format`` cannot); a key with no value reads 0, and a '/'
    in the result becomes '_'."""

    def sub(m):
        key, spec = m.group(1), m.group(2)
        value = metrics.get(key)
        if value is None:
            return "0"
        if spec:
            try:
                return format(value, spec)
            except (TypeError, ValueError):
                return format(float(value), spec)
        return str(value)

    return _FMT_TOKEN.sub(sub, pattern).replace("/", "_")


class ModelCheckpoint(Callback):
    """Top-k checkpoints on a monitored metric, and ``last`` at every epoch
    end with ``save_last`` (reference ``configs/callbacks/model_checkpoint.yaml``)."""

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: Optional[str] = None,
        monitor: Optional[str] = None,
        verbose: bool = False,
        save_last: Optional[bool] = None,
        save_top_k: int = 1,
        mode: str = "min",
        auto_insert_metric_name: bool = True,
        save_weights_only: bool = False,
        every_n_train_steps: Optional[int] = None,
        every_n_epochs: Optional[int] = None,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.dirpath = dirpath
        self.filename = filename or "epoch_{epoch:03d}"
        self.monitor = monitor
        self.verbose = verbose
        self.save_last = bool(save_last)
        self.save_top_k = save_top_k
        self.mode = mode
        self.auto_insert_metric_name = auto_insert_metric_name
        self.save_weights_only = save_weights_only
        self.every_n_train_steps = every_n_train_steps
        self.every_n_epochs = every_n_epochs
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self._saved: list[tuple[float, str]] = []  # (score, path), best first

    def setup(self, trainer, module) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir, "checkpoints")
        if dist.is_main_process():
            os.makedirs(self.dirpath, exist_ok=True)

    def _is_better(self, score: float, than: float) -> bool:
        return score < than if self.mode == "min" else score > than

    def _maybe_save_topk(self, trainer, metrics: dict, epoch: int) -> None:
        if self.monitor is None or self.monitor not in metrics:
            return
        score = float(metrics[self.monitor])
        if math.isnan(score):
            return
        if (self.save_top_k != -1 and len(self._saved) >= self.save_top_k
                and not self._is_better(score, self._saved[-1][0])):
            return
        name = _format_filename(
            self.filename, {**metrics, "epoch": epoch, "step": trainer.global_step},
            self.auto_insert_metric_name)
        path = os.path.join(self.dirpath, name)
        trainer.save_checkpoint(path, weights_only=self.save_weights_only)
        self._saved.append((score, path))
        self._saved.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        if self.save_top_k != -1:
            for _, stale in self._saved[self.save_top_k:]:
                if dist.is_main_process():
                    shutil.rmtree(stale, ignore_errors=True)
            self._saved = self._saved[: self.save_top_k]
        self.best_model_score, self.best_model_path = self._saved[0]
        if self.verbose:
            log.info(f"Checkpoint saved: {path} ({self.monitor}={score:.5f})")

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        self._maybe_save_topk(trainer, metrics, epoch)

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._maybe_save_topk(trainer, metrics, epoch)
        if self.save_last:
            path = os.path.join(self.dirpath, "last")
            trainer.save_checkpoint(path, weights_only=False)
            self.last_model_path = path


class EarlyStopping(Callback):
    """Stops the fit after ``patience`` validations without an improvement
    of ``min_delta``, or at once on a non-finite value with
    ``check_finite`` (``configs/callbacks/early_stopping.yaml``)."""

    def __init__(
        self,
        monitor: str,
        min_delta: float = 0.0,
        patience: int = 3,
        verbose: bool = False,
        mode: str = "min",
        strict: bool = True,
        check_finite: bool = True,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.strict = strict
        self.check_finite = check_finite
        self.wait = 0
        self.best: Optional[float] = None

    def on_validation_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if self.monitor not in metrics:
            if self.strict:
                log.warning(f"EarlyStopping: metric '{self.monitor}' not found")
            return
        score = float(metrics[self.monitor])
        if self.check_finite and not math.isfinite(score):
            trainer.should_stop = True
            log.warning(f"EarlyStopping: non-finite {self.monitor}; stopping")
            return
        improved = self.best is None or (
            score < self.best - self.min_delta if self.mode == "min"
            else score > self.best + self.min_delta)
        if improved:
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True
                if self.verbose:
                    log.info(f"EarlyStopping triggered on {self.monitor}")


class LearningRateMonitor(Callback):
    """Logs the trainer's learning rate at each epoch end
    (``configs/callbacks/lr_monitor.yaml``)."""

    def __init__(self, logging_interval: Optional[str] = None):
        self.logging_interval = logging_interval

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        lr = trainer.current_lr()
        if lr is not None:
            trainer.log_metrics({"lr": lr})


class ModelSummary(Callback):
    """The policy's parameter count at fit start, and with ``max_depth`` != 0
    the count of each top-level child, largest first
    (``configs/callbacks/model_summary.yaml``)."""

    def __init__(self, max_depth: int = 1):
        self.max_depth = max_depth

    def on_fit_start(self, trainer, module) -> None:
        policy = module.policy
        log.info(f"Model parameters: {sum(p.numel() for p in policy.parameters()):,}")
        if self.max_depth != 0:
            top = {name: sum(p.numel() for p in child.parameters())
                   for name, child in policy.named_children()}
            top.update({name: p.numel() for name, p in policy.named_parameters(recurse=False)})
            for name, n in sorted(top.items(), key=lambda kv: -kv[1]):
                log.info(f"  {name}: {n:,}")


class RichProgressBar(Callback):
    """A log line an epoch with its metrics (Lightning's rich bar, without
    ``rich``)."""

    def __init__(self, refresh_rate: int = 1, leave: bool = False, **_):
        pass

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        parts = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
        log.info(f"epoch {epoch}: {parts}")


ProgressBar = RichProgressBar


class StochasticWeightAveraging(Callback):
    """Stochastic Weight Averaging (``configs/callbacks/
    stochastic_weight_averaging.yaml``; the JAX callback's semantics,
    ``callbacks.py:248-425`` of the JAX package, quirks included):

    - ``setup`` (after a resume, before the first step) rebuilds the
      optimizer and its schedule with the learning rate wrapped: from
      ``start_epoch * steps_per_epoch`` (``steps_per_epoch = total //
      max_epochs``) it anneals, cos or linear, from the base schedule's rate
      at that step to ``swa_lrs`` over ``annealing_epochs * steps_per_epoch``
      steps and then holds. Without a scheduler the whole run is at
      ``swa_lrs``, before the start too. OneCycleLR's beta1 cycle stays as
      built. The optimizer starts from a fresh state even after a resume
      (ROADMAP.md §3, both kept alike); the trainer then logs the wrapped
      rate.
    - From ``swa_epoch_start`` (a fraction of ``max_epochs`` when a float
      below 1, else an epoch) each epoch's end parameters enter the average,
      ``a + (p - a) / (n + 1)`` in f32, or ``avg_fn(a, p, n)``.
    - ``on_fit_end`` swaps the average into the policy and refreshes every
      running statistic to the uniform mean of the per-batch statistics
      that the running update takes (the unbiased variance of
      ``MaskedBatchNorm``, the hole-counting statistics of
      ``GroupedBNReluMax``, every branch of SpUNet's ``PDBatchNorm``) over
      ``bn_update_steps`` batches of the train loader (-1: a whole epoch),
      from train-mode f32 forwards of the averaged weights: each norm's
      momentum is set to 1 for the pass, so its buffers hold that batch's
      statistics exactly. A buffer that no forward moves becomes 0, as
      JAX's probe from zeros and ones leaves it. Under data parallelism the
      statistics are the global batch's, as in the step. Checkpoints
      written at epoch ends keep the weights that were not averaged.
    """

    def __init__(self, swa_lrs, swa_epoch_start: float = 0.8, annealing_epochs: int = 10,
                 annealing_strategy: str = "cos", avg_fn=None, device=None,
                 bn_update_steps: int = -1):
        del device  # Lightning's key; the average lives beside the parameters
        if annealing_strategy not in ("cos", "linear"):
            raise ValueError(f"annealing_strategy={annealing_strategy!r}")
        self.swa_lrs = float(swa_lrs[0] if isinstance(swa_lrs, (list, tuple)) else swa_lrs)
        self.swa_epoch_start = swa_epoch_start
        self.annealing_epochs = int(annealing_epochs)
        self.annealing_strategy = annealing_strategy
        self.avg_fn = avg_fn
        self.bn_update_steps = bn_update_steps
        self.n_averaged = 0
        self._avg: Optional[dict[str, torch.Tensor]] = None
        self._swa_start_epoch: Optional[int] = None

    def swa_schedule(self, base, swa_start_step: float, anneal_steps: float):
        """The learning rate of step ``s``: ``base(s)`` (``swa_lrs`` without
        a base) before ``swa_start_step``, then the anneal to ``swa_lrs``;
        in f32, as the JAX schedule."""
        f32 = np.float32
        swa_lr = f32(self.swa_lrs)
        lr0 = f32(base(swa_start_step)) if base is not None else swa_lr
        start, span = f32(swa_start_step), f32(max(anneal_steps, 1.0))
        cos = self.annealing_strategy == "cos"

        def schedule(step) -> float:
            s = f32(step)
            if s < start:
                return float(swa_lr) if base is None else float(f32(base(step)))
            t = min(max((s - start) / span, f32(0)), f32(1))
            frac = (f32(1) - np.cos(f32(np.pi) * t, dtype=f32)) / f32(2) if cos else t
            return float(lr0 + (swa_lr - lr0) * frac)

        return schedule

    def setup(self, trainer, module) -> None:
        if isinstance(self.swa_epoch_start, float) and self.swa_epoch_start < 1:
            self._swa_start_epoch = int(trainer.max_epochs * self.swa_epoch_start)
        else:
            self._swa_start_epoch = int(self.swa_epoch_start)
        total = trainer.estimated_stepping_batches or 1
        steps_per_epoch = max(1, total // max(trainer.max_epochs, 1))
        swa_start_step = float(self._swa_start_epoch * steps_per_epoch)
        anneal_steps = float(self.annealing_epochs * steps_per_epoch)
        module.configure_optimizers(
            total, trainer.gradient_clip_val, trainer.accumulate_grad_batches,
            schedule_transform=lambda base: self.swa_schedule(base, swa_start_step,
                                                              anneal_steps))
        trainer._schedule = module.scheduler

    @torch.no_grad()
    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        if epoch < (self._swa_start_epoch or 0):
            return
        params = {name: p.detach() for name, p in module.policy.named_parameters()}
        if self._avg is None:
            self._avg = {name: p.clone() for name, p in params.items()}
        elif self.avg_fn is not None:
            self._avg = {name: self.avg_fn(a, params[name], self.n_averaged)
                         for name, a in self._avg.items()}
        else:
            # a true division by a device tensor, as JAX divides
            n1 = torch.full((), self.n_averaged + 1.0, device=next(iter(params.values())).device)
            for name, a in self._avg.items():
                a.add_((params[name] - a) / n1.to(a.dtype))
        self.n_averaged += 1

    @torch.no_grad()
    def refresh_batch_stats(self, trainer, module) -> Optional[dict[str, torch.Tensor]]:
        """The refreshed running statistics of the policy as it stands
        (class doc), or None where there are none or no train loader."""
        from pointcloudmatters_tpu_torch.models.components.nn_utils import _RunningNorm

        policy = module.policy
        params = {name for name, _ in policy.named_parameters()}
        stats = {name: b for name, b in policy.state_dict().items()
                 if name not in params and b.is_floating_point()}
        dm = getattr(trainer, "datamodule", None)
        if not stats or dm is None:
            return None
        loader = dm.train_dataloader()
        limit = self.bn_update_steps if self.bn_update_steps != -1 else len(loader)
        norms = [m for m in policy.modules() if isinstance(m, _RunningNorm)]
        momenta = [m.momentum for m in norms]
        acc, count = None, 0
        try:
            for m in norms:
                m.momentum = 1.0
            for i, batch in enumerate(loader):
                if i >= limit:
                    break
                for b in stats.values():
                    b.zero_()
                module.forward_train(batch, module.make_rngs(i, dist.get_rank(),
                                                             dist.get_world_size()))
                if acc is None:
                    acc = {name: b.clone() for name, b in stats.items()}
                else:
                    n1 = torch.full((), count + 1.0, device=module.device)
                    for name, a in acc.items():
                        a.add_((stats[name] - a) / n1.to(a.dtype))
                count += 1
        finally:
            for m, momentum in zip(norms, momenta):
                m.momentum = momentum
        return acc

    @torch.no_grad()
    def on_fit_end(self, trainer, module) -> None:
        if self._avg is None or self.n_averaged == 0:
            return
        log.info(f"SWA: swapping in the average of {self.n_averaged} epoch-end parameter "
                 "snapshots and refreshing BN statistics")
        policy = module.policy
        saved = {name: b.clone() for name, b in policy.state_dict().items()
                 if name not in self._avg}
        for name, p in policy.named_parameters():
            p.copy_(self._avg[name])
        fresh = self.refresh_batch_stats(trainer, module)
        state = policy.state_dict()
        for name, b in saved.items():  # None: the statistics stay as they were
            state[name].copy_(b if fresh is None or name not in fresh else fresh[name])


class DeviceStatsMonitor(Callback):
    """Logs the card's memory in use at each epoch end as
    ``device<i>/bytes_in_use`` (``configs/callbacks/device_stats_monitor.yaml``);
    logs nothing for a module on the CPU."""

    def on_train_epoch_end(self, trainer, module, metrics: dict, epoch: int) -> None:
        device = module.device
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        trainer.log_metrics(
            {f"device{device.index}/bytes_in_use": stats.get("allocated_bytes.all.current", 0)})
