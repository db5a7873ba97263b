"""Experiment loggers (port of ``pointcloudmatters_tpu/utils/loggers.py``):
CSV, TensorBoard, a fan-out ``MultiLogger`` and the offline stand-ins of the
networked back ends (wandb, comet, mlflow, neptune, aim), which log through
the CSV path and record the back end's configuration beside it.

``TensorBoardLogger`` writes event files through torch's ``SummaryWriter``
when that imports, and CSV under the same directory when it does not, as the
JAX package's logger does.

Under data parallelism only rank 0 writes (Lightning's loggers'
``rank_zero_only``): on the other ranks these loggers make no directory and
no file, and log nothing."""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Optional
from urllib.parse import urlparse

from pointcloudmatters_tpu_torch.utils.dist import is_main_process, rank_zero_only

__all__ = ["BaseLogger", "CSVLogger", "OfflineBackendLogger", "WandbLogger", "CometLogger",
           "MLFlowLogger", "NeptuneLogger", "AimLogger", "TensorBoardLogger", "MultiLogger",
           "as_multi_logger"]


class BaseLogger:
    def log_metrics(self, metrics: dict, step: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def log_hyperparams(self, params: dict) -> None:
        pass

    def finalize(self) -> None:
        pass


class CSVLogger(BaseLogger):
    """One ``metrics.csv`` a run, a row a ``log_metrics`` call (reference
    ``configs/logger/csv.yaml``). Values are read with ``float``: a device
    tensor is copied to the host here."""

    def __init__(self, save_dir: str, name: str = "csv", prefix: str = ""):
        self.save_dir = os.path.join(save_dir, name) if name else save_dir
        if is_main_process():
            os.makedirs(self.save_dir, exist_ok=True)
        self.prefix = prefix
        self.path = os.path.join(self.save_dir, "metrics.csv")
        self._fieldnames: list[str] = ["step"]
        self._rows: list[dict] = []

    @rank_zero_only
    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            key = f"{self.prefix}{k}" if self.prefix else k
            row[key] = float(v)
            if key not in self._fieldnames:
                self._fieldnames.append(key)
        self._rows.append(row)
        self._flush()

    def _flush(self) -> None:
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)

    @rank_zero_only
    def log_hyperparams(self, params: dict) -> None:
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)


class OfflineBackendLogger(CSVLogger):
    """Stand-in for a networked experiment-tracking back end: takes the real
    back end's constructor keys, records them to ``backend_config.json``
    beside the metrics, and logs through the CSV path."""

    backend = "offline"

    def __init__(self, save_dir: Optional[str] = None, name: str = "",
                 prefix: str = "", **backend_kwargs: Any):
        if save_dir is None:
            # mlflow-style configs carry a tracking URI: a file: URI's path,
            # else "logs" (a remote host is not a directory)
            raw = str(backend_kwargs.get("tracking_uri")
                      or backend_kwargs.get("run_directory") or "logs")
            parsed = urlparse(raw)
            if parsed.scheme in ("", "file"):
                save_dir = (parsed.path or "logs") if parsed.scheme else raw
            else:
                save_dir = "logs"
        super().__init__(save_dir, name=name or self.backend, prefix=prefix)
        self.backend_config = dict(backend_kwargs)
        if not is_main_process():
            return
        with open(os.path.join(self.save_dir, "backend_config.json"), "w") as fh:
            json.dump({"backend": self.backend, **self.backend_config}, fh, indent=2,
                      default=str)


class WandbLogger(OfflineBackendLogger):
    backend = "wandb"


class CometLogger(OfflineBackendLogger):
    backend = "comet"


class MLFlowLogger(OfflineBackendLogger):
    backend = "mlflow"


class NeptuneLogger(OfflineBackendLogger):
    backend = "neptune"


class AimLogger(OfflineBackendLogger):
    backend = "aim"


class TensorBoardLogger(BaseLogger):
    """Event files through torch's ``SummaryWriter`` when it imports
    (reference ``configs/logger/tensorboard.yaml``), else CSV under the same
    directory. ``writer`` says which: ``"tensorboard"`` or ``"csv"``."""

    def __init__(self, save_dir: str, name: str = "tensorboard",
                 default_hp_metric: bool = False, prefix: str = "",
                 log_graph: bool = False, version: Optional[str] = None):
        del default_hp_metric, log_graph, version
        self.save_dir = os.path.join(save_dir, name) if name else save_dir
        self.prefix = prefix
        self._writer: Any = None
        if not is_main_process():
            return
        os.makedirs(self.save_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._fallback = CSVLogger(self.save_dir, name="")
        else:
            self._writer = SummaryWriter(log_dir=self.save_dir)

    @property
    def writer(self) -> str:
        return "csv" if self._writer is None else "tensorboard"

    @rank_zero_only
    def log_metrics(self, metrics: dict, step: int) -> None:
        if self._writer is None:
            self._fallback.log_metrics(metrics, step)
            return
        for k, v in metrics.items():
            key = f"{self.prefix}{k}" if self.prefix else k
            self._writer.add_scalar(key, float(v), step)

    @rank_zero_only
    def log_hyperparams(self, params: dict) -> None:
        if self._writer is None:
            self._fallback.log_hyperparams(params)
            return
        self._writer.add_text("hparams", json.dumps(params, default=str))

    @rank_zero_only
    def log_figure(self, tag: str, figure, step: int) -> None:
        """A matplotlib figure (a rollout's reward curve); none under the CSV
        fallback."""
        if self._writer is not None:
            self._writer.add_figure(tag, figure, step)

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()


class MultiLogger(BaseLogger):
    """Fan-out (reference ``configs/logger/many_loggers.yaml``)."""

    def __init__(self, loggers: list):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_metrics(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params: dict) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def finalize(self) -> None:
        for lg in self.loggers:
            lg.finalize()


def as_multi_logger(logger) -> MultiLogger:
    if logger is None:
        return MultiLogger([])
    if isinstance(logger, MultiLogger):
        return logger
    if isinstance(logger, dict):
        return MultiLogger(list(logger.values()))
    if isinstance(logger, (list, tuple)):
        return MultiLogger(list(logger))
    return MultiLogger([logger])
