"""Optimizers from ``{"type": ...}`` config dicts (port of
``pointcloudmatters_tpu/utils/optimizer.py:37-136``), on torch's own
optimizers, whose semantics the JAX chains were written to reproduce:
``SGD`` and ``Adam`` apply coupled L2 decay (added to the gradient),
``AdamW`` decoupled decay scaled by the learning rate.

:class:`GradientMean` is the gradient accumulation of ``optax.MultiSteps``
(``accumulate_grad_batches``).

Keyword-matched parameter groups (``param_dicts``) and the timm-style
builder are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

__all__ = ["build_optimizer", "clip_by_global_norm", "global_norm", "GradientMean"]

_OPTIMIZERS = {
    "SGD": torch.optim.SGD,
    "Adam": torch.optim.Adam,
    "AdamW": torch.optim.AdamW,
}


def build_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                    param_dicts: Optional[Sequence[dict]] = None
                    ) -> torch.optim.Optimizer:
    """A torch optimizer from ``{"type": "AdamW", "lr": ..., ...}``."""
    if param_dicts:
        raise NotImplementedError(
            "keyword-matched parameter groups (param_dicts) are not ported yet")
    cfg = dict(cfg)
    opt_type = cfg.pop("type")
    if opt_type not in _OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported; options: {sorted(_OPTIMIZERS)}")
    lr = float(cfg.pop("lr"))
    if "betas" in cfg:
        cfg["betas"] = tuple(cfg["betas"])
    return _OPTIMIZERS[opt_type](params, lr=lr, **cfg)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``;
    stays on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place: where ``norm >= max_norm``,
    every tensor becomes ``(t / norm) * max_norm``; no host sync."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(tensors), scale)


class GradientMean:
    """The running mean of ``every_k`` micro-batches' gradients, as
    ``optax.MultiSteps`` keeps it: ``acc + (g - acc) / (i + 1)`` (Welford,
    in the gradients' type), not a sum divided by k. ``mini_step`` carries
    over from one epoch to the next, as optax's state does."""

    def __init__(self, every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.acc: Optional[list[torch.Tensor]] = None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Fold ``grads`` into the mean. On the k-th call, write the mean
        into ``grads``, start a new mean and return True (the optimizer
        steps on it); else return False and leave the parameters alone."""
        grads = list(grads)
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        diff = torch._foreach_sub(grads, self.acc)
        # a true division by a device tensor: a Python scalar divisor may be
        # taken as a product with its rounded reciprocal (1/3 is not exact)
        torch._foreach_div_(diff, torch.full((), self.mini_step + 1.0, dtype=grads[0].dtype,
                                             device=grads[0].device))
        torch._foreach_add_(self.acc, diff)
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        torch._foreach_copy_(grads, self.acc)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        """The mean and its count, as ``optax.MultiSteps`` saves
        ``acc_grads`` and ``mini_step`` (``acc`` is None before the first
        micro-batch)."""
        return {"mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.detach().clone() for a in self.acc]}

    @torch.no_grad()
    def load_state_dict(self, state: dict, device: Optional[torch.device] = None) -> None:
        """Restore :meth:`state_dict`; the mean goes to ``device`` (where the
        gradients are) when given."""
        self.mini_step = int(state["mini_step"])
        acc = state["acc"]
        self.acc = None if acc is None else [a.to(device=device, copy=True) for a in acc]
