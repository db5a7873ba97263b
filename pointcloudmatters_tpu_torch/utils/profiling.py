"""Profiling of the fit loop (port of ``pointcloudmatters_tpu/utils/profiling.py``).

The reference exposes Lightning's ``trainer.profiler: simple`` through
``debug=profiler`` (``configs/debug/profiler.yaml:10``). Here ``profiler:
simple | advanced | pytorch | torch | true`` on the ``Trainer`` runs the fit
loop under ``torch.profiler`` (the host's ops, and the card's kernels where
there is a card) and writes ``<default_root_dir>/torch_trace/trace.json``
(Chrome / Perfetto format) and ``summary.txt`` (the ops by total time).
``device_memory_stats`` reads each card's allocator counters.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["TorchProfiler", "device_memory_stats", "make_profiler", "TRACE_FILE",
           "SUMMARY_FILE"]

log = RankedLogger(__name__, rank_zero_only=True)

TRACE_FILE = "trace.json"
SUMMARY_FILE = "summary.txt"


class TorchProfiler:
    """``start`` .. ``stop`` under ``torch.profiler``; ``stop`` writes the
    trace and the summary into ``log_dir/torch_trace``."""

    def __init__(self, log_dir: str):
        self.log_dir = os.path.join(log_dir, "torch_trace")
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()
        log.info(f"torch profiler trace -> {self.log_dir}")

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_FILE))
        on_card = torch.cuda.is_available()
        table = prof.key_averages().table(
            sort_by="self_cuda_time_total" if on_card else "self_cpu_time_total", row_limit=50)
        with open(os.path.join(self.log_dir, SUMMARY_FILE), "w") as f:
            f.write(table)
        log.info(f"torch profiler trace saved to {self.log_dir}; device memory "
                 f"{device_memory_stats()}")


def device_memory_stats() -> dict:
    """Each card's bytes in use, peak and total (``torch.cuda.memory_stats``);
    empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        mem = torch.cuda.memory_stats(i)
        stats[f"device{i}"] = {
            "bytes_in_use": mem.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": mem.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


def make_profiler(kind, log_dir: str) -> Optional[TorchProfiler]:
    """The profiler a trainer's ``profiler`` names: None for none, else a
    ``TorchProfiler`` writing under ``log_dir``; ``ValueError`` on a kind
    it does not know."""
    if kind in (None, False, "", "none"):
        return None
    if kind in ("torch", "simple", "advanced", "pytorch", True):
        return TorchProfiler(log_dir)
    raise ValueError(f"unknown profiler {kind!r}")
