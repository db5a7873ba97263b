"""Metric accumulators that stay on the device (port of
``pointcloudmatters_tpu/utils/metrics.py``'s ``MeanMetric`` and
``Metrics``). ``update`` only enqueues device work: nothing is read back
until ``compute``, where the JAX package reads every value with ``float()``
at every step. NaN values are skipped, as there."""

from __future__ import annotations

from typing import Any, Sequence

import torch

__all__ = ["MeanMetric", "Metrics"]


class MeanMetric:
    """Weighted mean of the values given to ``update``, summed in f64 on the
    values' device."""

    def __init__(self):
        self.total = None
        self.count = None

    def update(self, value: torch.Tensor, weight: float = 1.0) -> None:
        value = torch.as_tensor(value).detach().to(torch.float64)
        nan = torch.isnan(value)
        total = torch.where(nan, 0.0, value * weight)
        count = torch.where(nan, 0.0, torch.full_like(value, weight))
        if self.total is None:
            self.total, self.count = total, count
        else:
            self.total, self.count = self.total + total, self.count + count

    def compute(self) -> torch.Tensor:
        """The mean as a 0-d f64 tensor on the device (NaN if empty)."""
        if self.total is None:
            return torch.tensor(float("nan"), dtype=torch.float64)
        return self.total / self.count

    def reset(self) -> None:
        self.total = self.count = None


def _build_metric(spec: Any) -> MeanMetric:
    if hasattr(spec, "update") and hasattr(spec, "compute"):
        return spec
    name = spec if isinstance(spec, str) else spec.get("type", spec.get("_target_"))
    if str(name).split(".")[-1] != "MeanMetric":
        raise NotImplementedError(f"metric {name!r} is not ported yet; only "
                                  f"MeanMetric is")
    return MeanMetric()


class Metrics:
    """Routes step-output keys into accumulators: ``metrics``,
    ``input_keys`` (read from the step's outputs) and ``output_keys``
    (names at ``compute``), the JAX class's config schema."""

    def __init__(self, metrics: Sequence[Any], input_keys: Sequence[str],
                 output_keys: Sequence[str]):
        if not len(metrics) == len(input_keys) == len(output_keys):
            raise ValueError("metrics, input_keys and output_keys differ in length")
        self.metrics = [_build_metric(m) for m in metrics]
        self.input_keys = list(input_keys)
        self.output_keys = list(output_keys)

    def update(self, outputs: dict, weight: float = 1.0) -> None:
        for metric, key in zip(self.metrics, self.input_keys):
            if outputs.get(key) is not None:
                metric.update(outputs[key], weight)

    def compute(self) -> dict[str, torch.Tensor]:
        return {out: m.compute() for m, out in zip(self.metrics, self.output_keys)}

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
