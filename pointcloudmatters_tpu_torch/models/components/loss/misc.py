"""Losses of the policy heads (port of
``pointcloudmatters_tpu/models/components/loss/misc.py:17-76``): the CVAE
KL term and the elementwise action losses the configs name
(``torch.nn.{MSELoss,L1Loss}(reduction="none")``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "KLDivergence",
    "mse_loss",
    "l1_loss",
    "build_action_loss",
    "masked_action_loss",
]


class KLDivergence:
    """Unit-Gaussian KL of the CVAE latent: the sum over latent dimensions,
    the mean over the batch; 0 without a posterior."""

    def __call__(self, mu: Optional[torch.Tensor],
                 logvar: Optional[torch.Tensor]) -> torch.Tensor:
        if mu is None:
            return torch.zeros(())
        klds = -0.5 * (1 + logvar - mu * mu - torch.exp(logvar))
        return klds.sum(dim=-1).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise squared error (``reduction="none"``)."""
    diff = pred - target
    return diff * diff


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise absolute error (``reduction="none"``)."""
    return torch.abs(pred - target)


_ACTION_LOSSES = {
    "mse": mse_loss,
    "l2": mse_loss,
    "MSELoss": mse_loss,
    "l1": l1_loss,
    "L1Loss": l1_loss,
}


def build_action_loss(spec) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """An action loss from a callable, a name, or a config dict whose
    ``type``/``_target_`` tail names it; None means MSE."""
    if callable(spec):
        return spec
    if spec is None:
        return mse_loss
    name = spec if isinstance(spec, str) else spec.get("type", spec.get("_target_", "mse"))
    name = str(name).split(".")[-1]
    if name not in _ACTION_LOSSES:
        raise KeyError(f"unknown action loss {name!r}; options: {sorted(_ACTION_LOSSES)}")
    return _ACTION_LOSSES[name]


def masked_action_loss(loss_fn: Callable, a_hat: torch.Tensor,
                       actions: torch.Tensor, is_pad: torch.Tensor) -> torch.Tensor:
    """Padded chunk slots zeroed, then the mean over *all* elements: the
    reference divides by the full element count, not the valid one."""
    per_elem = loss_fn(a_hat, actions)
    keep = (~is_pad)[..., None].to(per_elem.dtype)
    return (per_elem * keep).mean()
