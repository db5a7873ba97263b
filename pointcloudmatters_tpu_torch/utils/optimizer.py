"""Optimizers from ``{"type": ...}`` config dicts (port of
``pointcloudmatters_tpu/utils/optimizer.py:37-136``), on torch's own
optimizers, whose semantics the JAX chains were written to reproduce:
``SGD`` and ``Adam`` apply coupled L2 decay (added to the gradient),
``AdamW`` decoupled decay scaled by the learning rate.

Keyword-matched parameter groups (``param_dicts``) and the timm-style
builder are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

__all__ = ["build_optimizer", "clip_by_global_norm", "global_norm"]

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
