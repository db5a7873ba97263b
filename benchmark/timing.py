"""Kernel time on the card by CUDA events."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cuda_seconds"]


def cuda_seconds(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Mean seconds of ``fn()`` on the card over ``reps`` calls in a row,
    after ``warmup`` calls, by CUDA events around the whole run."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps
