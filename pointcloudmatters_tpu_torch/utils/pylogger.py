"""Rank-aware logger (port of ``pointcloudmatters_tpu/utils/pylogger.py``).

Log lines carry the process's rank: ``torch.distributed``'s when a process
group is initialised, else 0.
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class RankedLogger(logging.LoggerAdapter):
    """Logger adapter that prefixes the rank on every record; with
    ``rank_zero_only`` (or a ``rank=`` argument) only that rank logs."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False, extra=None):
        logger = logging.getLogger(name)
        if not logger.handlers and not logging.getLogger().handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(
                logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
            )
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
        super().__init__(logger=logger, extra=extra)
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, rank=None, **kwargs):
        if not self.isEnabledFor(level):
            return
        current_rank = _rank()
        msg, kwargs = self.process(f"[rank: {current_rank}] {msg}", kwargs)
        if self.rank_zero_only or rank is not None:
            if current_rank == (0 if rank is None else rank):
                self.logger.log(level, msg, *args, **kwargs)
        else:
            self.logger.log(level, msg, *args, **kwargs)
