"""Learning-rate schedules from ``{"type": ...}`` config dicts (port of
``pointcloudmatters_tpu/utils/scheduler.py:89-179``).

:class:`OneCycleLR` is torch's one-cycle cosine schedule, ``cycle_momentum``
included (Adam's beta1 cycles ``max_momentum -> base_momentum`` over the
warm-up and back over the anneal; the JAX package models this with
``build_momentum_schedule``; other optimizers keep their configured momentum
there, and here), with the JAX schedule's phase clamp
(``scheduler.py:128-129``: the warm-up spans at least 1 step and the anneal
at least 1 more). Where no phase is clamped it is torch's schedule; a 1- or
2-step debug run gets a finite learning rate where torch's phases would have
zero length; and past ``total_steps`` it stays at its floor, as the JAX
schedule does, where torch's class raises.

The other schedulers of the JAX registry are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["build_scheduler", "OneCycleLR"]

_ONE_CYCLE_KEYS = ("max_lr", "pct_start", "div_factor", "final_div_factor",
                   "cycle_momentum", "base_momentum", "max_momentum")


def _anneal_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


class OneCycleLR(torch.optim.lr_scheduler.LRScheduler):
    """One-cycle cosine schedule with the JAX package's phase clamp: the
    learning rate and (with ``cycle_momentum``) beta1 at step ``s`` are
    ``scheduler.py``'s ``one_cycle_lr`` and ``build_momentum_schedule``.

    A checkpoint keeps the step (``last_epoch``), as the JAX optimizer's
    state keeps the schedule's count; the cycle's shape is this run's, as a
    JAX run resumed with more epochs builds its schedule over the new total.
    ``load_state_dict`` sets the step and writes the learning rate and
    beta1 of that step into the optimizer's ``param_groups``."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_lr: float,
                 total_steps: int, pct_start: float, div_factor: float,
                 final_div_factor: float, cycle_momentum: bool,
                 base_momentum: float, max_momentum: float):
        self.peak = float(max_lr)
        self.initial = self.peak / div_factor
        self.floor = self.initial / final_div_factor
        # ends of the warm-up and of the anneal, in steps
        self.e1 = max(pct_start * float(total_steps) - 1.0, 1.0)
        self.e2 = max(float(total_steps) - 1.0, self.e1 + 1.0)
        self.cycle_momentum = cycle_momentum
        self.momenta = (float(base_momentum), float(max_momentum))
        super().__init__(optimizer)

    def _at(self, start: float, peak: float, end: float, step: int) -> float:
        s = float(step)
        if s <= self.e1:
            return _anneal_cos(start, peak, min(max(s / self.e1, 0.0), 1.0))
        pct = min(max((s - self.e1) / (self.e2 - self.e1), 0.0), 1.0)
        return _anneal_cos(peak, end, pct)

    def get_lr(self) -> list[float]:
        if self.cycle_momentum:
            base, top = self.momenta
            beta1 = self._at(top, base, top, self.last_epoch)
            for group in self.optimizer.param_groups:
                group["betas"] = (beta1, group["betas"][1])
        lr = self.lr_at(self.last_epoch)
        return [lr for _ in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state_dict: dict) -> None:
        self.last_epoch = int(state_dict["last_epoch"])
        self._step_count = self.last_epoch + 1
        for group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            group["lr"] = lr
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]

    def lr_at(self, step: int) -> float:
        """The learning rate of optimizer step ``step``."""
        return self._at(self.initial, self.peak, self.floor, step)


def build_scheduler(optimizer: torch.optim.Optimizer, cfg: dict,
                    total_steps: int) -> Optional[torch.optim.lr_scheduler.LRScheduler]:
    """The schedule of ``cfg`` over ``total_steps`` optimizer steps, stepped
    once after every ``optimizer.step()``; ``max_lr`` defaults to the
    optimizer's learning rate, as the JAX builder's ``base_lr``."""
    cfg = dict(cfg)
    sched_type = cfg.pop("type")
    for key in ("total_steps", "interval", "frequency"):
        cfg.pop(key, None)
    if sched_type != "OneCycleLR":
        raise NotImplementedError(f"scheduler {sched_type!r} is not ported yet; "
                                  f"only OneCycleLR is")
    if cfg.pop("three_phase", False) or cfg.pop("anneal_strategy", "cos") != "cos":
        raise NotImplementedError("OneCycleLR is ported with one cosine cycle only")
    unknown = set(cfg) - set(_ONE_CYCLE_KEYS)
    if unknown:
        raise TypeError(f"OneCycleLR got unknown arguments {sorted(unknown)}")
    max_lr = cfg.get("max_lr")
    return OneCycleLR(
        optimizer,
        max_lr=float(optimizer.defaults["lr"] if max_lr is None else max_lr),
        total_steps=int(total_steps),
        pct_start=float(cfg.get("pct_start", 0.3)),
        div_factor=float(cfg.get("div_factor", 25.0)),
        final_div_factor=float(cfg.get("final_div_factor", 1e4)),
        # beta1 cycles only for Adam-type optimizers, as in the JAX builder
        cycle_momentum=bool(cfg.get("cycle_momentum", True))
        and "betas" in optimizer.defaults,
        base_momentum=float(cfg.get("base_momentum", 0.85)),
        max_momentum=float(cfg.get("max_momentum", 0.95)),
    )
