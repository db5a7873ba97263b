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

``StochasticWeightAveraging`` is in no shipped composition (only
``configs/callbacks/stochastic_weight_averaging.yaml`` names it) and is not
ported yet: it raises.
"""

from __future__ import annotations

import math
import os
import re
import shutil
from typing import Optional

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
    """Not ported yet (``configs/callbacks/stochastic_weight_averaging.yaml``,
    in no shipped composition)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StochasticWeightAveraging is not ported yet (ROADMAP.md §1 item 5)")


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
