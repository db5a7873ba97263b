"""Learning-rate schedules from ``{"type": ...}`` config dicts (port of
``pointcloudmatters_tpu/utils/scheduler.py``).

A schedule is a function of the optimizer step (an int) to the learning rate,
as the JAX package's optax schedules are; ``SCHEDULERS`` maps each config
``type`` to its builder, whose ``total_steps`` the trainer injects. The JAX
schedules run in f32 on the integer step, and so do these (numpy f32
scalars, rounded where XLA rounds: a Python-only subexpression in double,
rounded to f32 where it meets the step), so that they agree with JAX to f32
rounding:

- ``MultiStepLR`` / ``MultiStepWithWarmupLR``: the milestones are
  ``rate * total_steps`` as f32, crossed at ``step >= bound``;
- ``PolyLR`` divides the step by ``total_steps + 1``;
- ``ExpLR``, ``CosineAnnealingLR``: torch's curves over ``total_steps``;
- timm's ``CosineLRScheduler``: with one cycle (``cycle_mul``,
  ``cycle_limit``, ``k_decay`` 1) ``optax.warmup_cosine_decay_schedule``,
  whose ``decay_steps`` counts the warm-up; otherwise the general form, whose
  cycle index is clamped to ``cycle_limit - 1`` while the step within the
  cycle is not.

:class:`LRSchedule` is the scheduler the optimizer is stepped with: after
every ``optimizer.step()`` it sets each parameter group's learning rate to
the schedule's value times the group's ``lr_scale`` (a ``param_dicts``
group's ``lr / base_lr``, ``utils/optimizer.py``) and, where a beta1 schedule
is given, every Adam group's beta1 (``build_momentum_schedule``).

``OneCycleLR`` is torch's one-cycle cosine schedule, with the JAX
schedule's phase clamp (``scheduler.py:128-129``: the warm-up spans at least
1 step and the anneal at least 1 more), and with ``cycle_momentum`` Adam's
beta1 cycles ``max_momentum -> base_momentum`` over the warm-up and back
over the anneal (other optimizers keep their configured momentum, as in
JAX). Where no phase is clamped it is torch's schedule; a 1- or 2-step debug
run gets a finite learning rate where torch's phases would have zero length;
and past ``total_steps`` it stays at its floor, as the JAX schedule does,
where torch's class raises. JAX raises on ``three_phase`` and on a linear
anneal, and so does the port.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["Schedule", "SCHEDULERS", "LRSchedule", "build_scheduler",
           "build_momentum_schedule", "multi_step_lr", "multi_step_with_warmup_lr", "poly_lr",
           "exp_lr", "cosine_annealing_lr", "one_cycle_lr", "cosine_lr_scheduler"]

Schedule = Callable[[int], float]

_F32 = np.float32


def _f32(x) -> np.float32:
    return _F32(x)


def _count(bounds: np.ndarray, step) -> int:
    """How many f32 ``bounds`` the step has reached (``step >= bound``)."""
    return int(np.sum(_f32(step) >= bounds))


def multi_step_lr(base_lr: float, total_steps: int, milestones: Sequence[float],
                  gamma: float = 0.1) -> Schedule:
    """``base_lr * gamma ** (milestones passed)``, a milestone at
    ``rate * total_steps``."""
    bounds = np.asarray([rate * total_steps for rate in milestones], _F32)

    def schedule(step) -> float:
        return float(_f32(base_lr) * _f32(gamma) ** _f32(_count(bounds, step)))

    return schedule


def multi_step_with_warmup_lr(base_lr: float, total_steps: int,
                              milestones: Sequence[float], gamma: float = 0.1,
                              warmup_rate: float = 0.05,
                              warmup_scale: float = 1e-6) -> Schedule:
    """:func:`multi_step_lr` times a linear warm-up from ``warmup_scale``
    over the first ``warmup_rate * total_steps`` steps."""
    bounds = np.asarray([rate * total_steps for rate in milestones], _F32)
    warmup_steps = warmup_rate * total_steps

    def schedule(step) -> float:
        s = _f32(step)
        factor = _f32(gamma) ** _f32(_count(bounds, step))
        warm = _f32(1) - (_f32(1) - s / _f32(warmup_steps)) * _f32(1 - warmup_scale)
        coeff = warm if s <= _f32(warmup_steps) else _f32(1)
        return float(_f32(base_lr) * coeff * factor)

    return schedule


def poly_lr(base_lr: float, total_steps: int, power: float = 0.9) -> Schedule:
    """``base_lr * (1 - step / (total_steps + 1)) ** power``."""

    def schedule(step) -> float:
        frac = _f32(1) - _f32(step) / _f32(total_steps + 1)
        return float(_f32(base_lr) * frac ** _f32(power))

    return schedule


def exp_lr(base_lr: float, total_steps: int, gamma: float = 0.9) -> Schedule:
    """``base_lr * gamma ** (step / total_steps)``."""

    def schedule(step) -> float:
        return float(_f32(base_lr) * _f32(gamma) ** (_f32(step) / _f32(total_steps)))

    return schedule


def cosine_annealing_lr(base_lr: float, total_steps: int, eta_min: float = 0.0) -> Schedule:
    """torch's cosine anneal from ``base_lr`` to ``eta_min`` over
    ``total_steps``, one half period."""

    def schedule(step) -> float:
        cos = np.cos(_f32(math.pi) * _f32(step) / _f32(total_steps), dtype=_F32)
        return float(_f32(eta_min) + _f32((base_lr - eta_min) * 0.5) * (_f32(1) + cos))

    return schedule


def _one_cycle_bounds(pct_start: float, total_steps: int) -> tuple[float, float]:
    """The ends of the warm-up and of the anneal, in steps, each phase at
    least one step long (JAX ``scheduler.py:128-129``)."""
    e1 = max(pct_start * float(total_steps) - 1.0, 1.0)
    return e1, max(float(total_steps) - 1.0, e1 + 1.0)


def _anneal_cos(start: float, end: float, pct: np.float32) -> np.float32:
    cos = np.cos(_f32(math.pi) * pct, dtype=_F32)
    return _f32(end) + _f32((start - end) / 2.0) * (cos + _f32(1))


def _cycle(start: float, peak: float, end: float, e1: float, e2: float) -> Schedule:
    """``start -> peak`` over ``[0, e1]``, ``peak -> end`` over
    ``[e1, e2]``, cosine, clamped outside; in f32, as JAX's."""

    def schedule(step) -> float:
        s = _f32(step)
        if s <= _f32(e1):
            return float(_anneal_cos(start, peak, np.clip(s / _f32(e1), 0, 1)))
        return float(_anneal_cos(peak, end, np.clip((s - _f32(e1)) / _f32(e2 - e1), 0, 1)))

    return schedule


def one_cycle_lr(base_lr: float, total_steps: int, max_lr: Optional[float] = None,
                 pct_start: float = 0.3, anneal_strategy: str = "cos",
                 div_factor: float = 25.0, final_div_factor: float = 1e4,
                 cycle_momentum: bool = True, base_momentum: float = 0.85,
                 max_momentum: float = 0.95, three_phase: bool = False) -> Schedule:
    """The learning rate of ``OneCycleLR``; the momentum keys belong to
    :func:`build_momentum_schedule`."""
    del cycle_momentum, base_momentum, max_momentum
    if three_phase:
        raise NotImplementedError("three_phase OneCycleLR")
    if anneal_strategy != "cos":
        raise NotImplementedError(f"anneal_strategy={anneal_strategy!r}")
    peak = float(max_lr if max_lr is not None else base_lr)
    initial = peak / div_factor
    return _cycle(initial, peak, initial / final_div_factor,
                  *_one_cycle_bounds(pct_start, total_steps))


def build_momentum_schedule(cfg: dict, total_steps: int) -> Optional[Schedule]:
    """Adam's beta1 under ``OneCycleLR`` with ``cycle_momentum`` (torch's
    default): ``max_momentum -> base_momentum`` over the warm-up and back
    over the anneal, on the learning rate's phases. None for every other
    schedule and for ``cycle_momentum=False``."""
    cfg = dict(cfg)
    if cfg.get("type") != "OneCycleLR" or not cfg.get("cycle_momentum", True):
        return None
    if cfg.get("anneal_strategy", "cos") != "cos":
        raise NotImplementedError("anneal_strategy != 'cos'")
    top = float(cfg.get("max_momentum", 0.95))
    return _cycle(top, float(cfg.get("base_momentum", 0.85)), top,
                  *_one_cycle_bounds(float(cfg.get("pct_start", 0.3)), total_steps))


def _polynomial(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init -> end`` over ``transition_steps``,
    constant at ``init_value`` when that is not positive."""
    if transition_steps <= 0:
        return lambda step: _f32(init_value)

    def schedule(step) -> np.float32:
        count = min(max(int(step), 0), transition_steps)
        frac = _f32(1) - _f32(count) / _f32(transition_steps)
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(step) -> np.float32:
        count = min(_f32(step), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * count / _f32(decay_steps),
                                                 dtype=_F32))
        return _f32(init_value) * (_f32(1 - alpha) * cosine + _f32(alpha))

    return schedule


def cosine_lr_scheduler(base_lr: float, total_steps: int, t_initial: Optional[int] = None,
                        lr_min: float = 0.0, cycle_mul: float = 1.0,
                        cycle_decay: float = 1.0, cycle_limit: int = 1,
                        warmup_t: int = 0, warmup_lr_init: float = 0.0,
                        warmup_prefix: bool = False, k_decay: float = 1.0) -> Schedule:
    """timm's ``CosineLRScheduler``: a linear warm-up, then cosine cycles of
    ``t_initial`` steps (``cycle_mul`` times longer each), each peak
    ``cycle_decay`` times the last."""
    t_initial = int(t_initial or total_steps)
    if cycle_mul == 1.0 and cycle_limit == 1 and k_decay == 1.0:
        # optax.warmup_cosine_decay_schedule: its decay_steps counts the warm-up
        warmup_steps = max(warmup_t, 0)
        decay_steps = t_initial + (warmup_t if warmup_prefix else 0)
        alpha = 0.0 if base_lr == 0.0 else lr_min / base_lr
        warm = _polynomial(warmup_lr_init, base_lr, warmup_steps)
        decay = _cosine_decay(base_lr, decay_steps - warmup_steps, alpha)

        def fast(step) -> float:
            return float(warm(step) if step < warmup_steps else decay(step - warmup_steps))

        return fast

    def schedule(step) -> float:
        t = _f32(step)
        warm = _f32(warmup_lr_init) + _f32(base_lr - warmup_lr_init) * t / _f32(max(warmup_t, 1))
        tt = t - _f32(warmup_t) if warmup_prefix else t
        if cycle_mul == 1.0:
            i = np.floor(tt / _f32(t_initial))
            t_i = _f32(t_initial)
            t_curr = tt - i * _f32(t_initial)
        else:
            i = np.floor(np.log1p(tt / _f32(t_initial) * _f32(cycle_mul - 1), dtype=_F32)
                         / np.log(_f32(cycle_mul), dtype=_F32))
            t_i = _f32(cycle_mul) ** i * _f32(t_initial)
            t_curr = tt - (_f32(1) - _f32(cycle_mul) ** i) / _f32(1 - cycle_mul) * _f32(t_initial)
        i = min(i, _f32(cycle_limit - 1))
        lr_max = _f32(base_lr) * _f32(cycle_decay) ** i
        frac = t_curr ** _f32(k_decay) / t_i ** _f32(k_decay)
        cos_lr = _f32(lr_min) + _f32(0.5) * (lr_max - _f32(lr_min)) * (
            _f32(1) + np.cos(_f32(math.pi) * frac, dtype=_F32))
        return float(warm if t < _f32(warmup_t) else cos_lr)

    return schedule


SCHEDULERS: dict[str, Callable[..., Schedule]] = {
    "MultiStepLR": multi_step_lr,
    "MultiStepWithWarmupLR": multi_step_with_warmup_lr,
    "PolyLR": poly_lr,
    "ExpLR": exp_lr,
    "CosineAnnealingLR": cosine_annealing_lr,
    "OneCycleLR": one_cycle_lr,
    "CosineLRScheduler": cosine_lr_scheduler,
}


class LRSchedule(torch.optim.lr_scheduler.LRScheduler):
    """Steps ``optimizer`` along ``schedule``: at step ``s`` (the optimizer
    steps taken) each parameter group's learning rate is ``schedule(s)``
    times its ``lr_scale`` (1 where unset), and with ``b1_schedule`` every
    group with ``betas`` gets beta1 ``b1_schedule(s)``.

    A checkpoint keeps the step (``last_epoch``), as the JAX optimizer's
    state keeps the schedule's count; ``load_state_dict`` sets the step and
    writes that step's rates (and beta1) into the groups."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule,
                 b1_schedule: Optional[Schedule] = None):
        self.schedule = schedule
        self.b1_schedule = b1_schedule
        super().__init__(optimizer)

    def lr_at(self, step: int) -> float:
        """The learning rate of optimizer step ``step`` (of a group of scale 1)."""
        return float(self.schedule(step))

    def get_lr(self) -> list[float]:
        if self.b1_schedule is not None:
            beta1 = float(self.b1_schedule(self.last_epoch))
            for group in self.optimizer.param_groups:
                if "betas" in group:
                    group["betas"] = (beta1, group["betas"][1])
        lr = self.lr_at(self.last_epoch)
        return [lr * group.get("lr_scale", 1.0) for group in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state_dict: dict) -> None:
        self.last_epoch = int(state_dict["last_epoch"])
        self._step_count = self.last_epoch + 1
        for group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            group["lr"] = lr
        self._last_lr = [group["lr"] for group in self.optimizer.param_groups]


def build_scheduler(optimizer: torch.optim.Optimizer, cfg: Optional[dict],
                    total_steps: int,
                    schedule_transform: Optional[Callable[[Optional[Schedule]], Schedule]] = None,
                    ) -> Optional[LRSchedule]:
    """The schedule of ``cfg`` over ``total_steps`` optimizer steps, stepped
    once after every ``optimizer.step()``; ``base_lr`` (and OneCycleLR's
    default ``max_lr``) is the optimizer's learning rate, as the JAX
    builder's. Under OneCycleLR an Adam-type optimizer's beta1 cycles too
    (:func:`build_momentum_schedule`), as in the JAX builder.
    ``schedule_transform`` wraps the learning rate's schedule (None where
    ``cfg`` is None), as the JAX module's does for SWA; beta1 stays as
    built. Returns None with neither."""
    if not cfg:
        return None if schedule_transform is None else LRSchedule(
            optimizer, schedule_transform(None))
    cfg = dict(cfg)
    sched_type = cfg.pop("type")
    for key in ("total_steps", "interval", "frequency"):
        cfg.pop(key, None)
    if sched_type not in SCHEDULERS:
        raise KeyError(f"{sched_type} is not in the schedulers registry")
    schedule = SCHEDULERS[sched_type](base_lr=float(optimizer.defaults["lr"]),
                                      total_steps=int(total_steps), **cfg)
    b1 = (build_momentum_schedule({"type": sched_type, **cfg}, int(total_steps))
          if "betas" in optimizer.defaults else None)
    if schedule_transform is not None:
        schedule = schedule_transform(schedule)
    return LRSchedule(optimizer, schedule, b1)
