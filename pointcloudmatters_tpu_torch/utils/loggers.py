"""Experiment loggers (port of ``pointcloudmatters_tpu/utils/loggers.py``'s
``BaseLogger``, ``CSVLogger``, ``MultiLogger`` and ``as_multi_logger``). The
TensorBoard and offline back ends are not ported yet."""

from __future__ import annotations

import csv
import json
import os

__all__ = ["BaseLogger", "CSVLogger", "MultiLogger", "as_multi_logger"]


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
        os.makedirs(self.save_dir, exist_ok=True)
        self.prefix = prefix
        self.path = os.path.join(self.save_dir, "metrics.csv")
        self._fieldnames: list[str] = ["step"]
        self._rows: list[dict] = []

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

    def log_hyperparams(self, params: dict) -> None:
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)


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
