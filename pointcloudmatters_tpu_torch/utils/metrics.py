"""Metric accumulators that stay on the device (port of
``pointcloudmatters_tpu/utils/metrics.py``). ``update`` only enqueues device
work: nothing is read back until ``compute``'s result is, where the JAX
package reads every value with ``float()`` at every step. NaN values are
skipped, as there.

Under data parallelism ``compute`` reduces each metric's state over the
default process group, on the device: a mean sums its totals and counts, a
sum its totals, a max or min takes the extreme. Every rank runs the same
loop, so a metric is empty on all ranks or on none, and an empty one
reduces nothing. A value that every rank holds alike (a global batch's) is
given with weight 1 / W on each, and then comes out as it went in."""


from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.distributed import ReduceOp

from pointcloudmatters_tpu_torch.utils import dist

__all__ = ["MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "Metrics"]


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

    def _reduced(self) -> tuple[torch.Tensor, torch.Tensor]:
        if not dist.is_initialized():
            return self.total, self.count
        state = torch.stack([self.total, self.count])
        dist.all_reduce_([state])
        return state[0], state[1]

    def compute(self) -> torch.Tensor:
        """The mean as a 0-d f64 tensor on the device (NaN if empty)."""
        if self.total is None:
            return torch.tensor(float("nan"), dtype=torch.float64)
        total, count = self._reduced()
        return total / count

    def reset(self) -> None:
        self.total = self.count = None


class SumMetric(MeanMetric):
    """Weighted sum of the values given to ``update`` (0 if empty)."""

    def compute(self) -> torch.Tensor:
        if self.total is None:
            return torch.tensor(0.0, dtype=torch.float64)
        return self._reduced()[0]


class MaxMetric:
    """Largest value given to ``update`` (-inf if empty); it persists
    across epochs until :meth:`reset`, the best-so-far tracker."""

    _pick, _empty = staticmethod(torch.maximum), -float("inf")
    _op = ReduceOp.MAX

    def __init__(self):
        self.value = None

    def update(self, value: torch.Tensor, weight: float = 1.0) -> None:
        del weight
        value = torch.as_tensor(value).detach().to(torch.float64)
        if self.value is None:
            self.value = torch.full_like(value, self._empty)
        self.value = torch.where(torch.isnan(value), self.value,
                                 self._pick(self.value, value))

    def compute(self) -> torch.Tensor:
        if self.value is None:
            return torch.tensor(self._empty, dtype=torch.float64)
        if not dist.is_initialized():
            return self.value
        value = self.value.clone()
        dist.all_reduce_([value], op=self._op)
        return value

    def reset(self) -> None:
        self.value = None


class MinMetric(MaxMetric):
    """Smallest value given to ``update`` (inf if empty)."""

    _pick, _empty = staticmethod(torch.minimum), float("inf")
    _op = ReduceOp.MIN


_METRICS = {cls.__name__: cls for cls in (MeanMetric, SumMetric, MaxMetric, MinMetric)}


def _build_metric(spec: Any):
    if hasattr(spec, "update") and hasattr(spec, "compute"):
        return spec
    name = spec if isinstance(spec, str) else spec.get("type", spec.get("_target_", "MeanMetric"))
    name = str(name).split(".")[-1]
    if name not in _METRICS:
        raise KeyError(f"unknown metric {name!r}; options: {sorted(_METRICS)}")
    return _METRICS[name]()


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
