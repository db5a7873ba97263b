"""Index-only dataset (port of ``pointcloudmatters_tpu/data/components/misc.py``'s
``DummyDataset``)."""

from __future__ import annotations

__all__ = ["DummyDataset"]


class DummyDataset:
    """``size`` indices; each stands for one validation rollout, and the
    held-out-loss validation skips a loader over it."""

    def __init__(self, size: int = 400, **kwargs):
        self.size = size

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        return idx
