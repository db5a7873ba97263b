"""Misc datasets (port of ``pointcloudmatters_tpu/data/components/misc.py``):
``DummyDataset`` and ``ExperienceSourceDataset``."""

from __future__ import annotations

from typing import Callable, Iterator

__all__ = ["DummyDataset", "ExperienceSourceDataset"]


class DummyDataset:
    """``size`` indices; each stands for one validation rollout, and the
    held-out-loss validation skips a loader over it."""

    def __init__(self, size: int = 400, **kwargs):
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        return idx


class ExperienceSourceDataset:
    """An iterable dataset over what ``generate_batch()`` yields, a new
    generator at every ``iter``."""

    def __init__(self, generate_batch: Callable[[], Iterator]):
        self.generate_batch = generate_batch

    def __iter__(self) -> Iterator:
        return self.generate_batch()
