"""Pretrained encoder weights from a local file (port of
``pointcloudmatters_tpu/models/components/pretrained.py``).

:func:`load_pretrained_into` runs right after a policy's weights are drawn
(``train.instantiate_model``): it walks the policy's modules, and for each
one whose ``pretrained_path`` is set it reads that local file (no download)
and copies the checkpoint in with its family's mapping. A path that does not
exist logs a warning and keeps the drawn weights, as in JAX. The port maps
the SpUNet family (PonderV2 checkpoints); the image encoders' families come
with their backbones (ROADMAP.md §1 item 11).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet import (
    SpUNet,
    load_ponderv2_weights,
)
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["load_pretrained_into"]

log = RankedLogger(__name__, rank_zero_only=True)


def _load_torch_file(path: str) -> dict:
    """The state dict of a checkpoint file, unwrapped from a ``state_dict``,
    ``model`` or ``r3m`` entry where it has one."""
    state = torch.load(os.path.expanduser(path), map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "r3m"):
        if isinstance(state, dict) and isinstance(state.get(key), dict):
            return state[key]
    return state


def _port(module: nn.Module, state_dict: dict) -> None:
    if isinstance(module, SpUNet):
        load_ponderv2_weights(module, state_dict)
        return
    raise NotImplementedError(
        f"no pretrained weights for {type(module).__name__} in the port yet "
        f"(ROADMAP.md §1 item 11: the image encoders' checkpoints)")


def load_pretrained_into(policy: nn.Module) -> nn.Module:
    """Copy every configured pretrained checkpoint into ``policy``'s
    encoders in place; a no-op where no module sets ``pretrained_path``.
    Returns the policy."""
    for name, module in policy.named_modules():
        path = getattr(module, "pretrained_path", None)
        if not path:
            continue
        if not os.path.exists(os.path.expanduser(str(path))):
            log.warning(f"pretrained_path {path} for {type(module).__name__} not found; "
                        "keeping random init")
            continue
        log.info(f"loading pretrained {type(module).__name__} ({name}) <- {path}")
        _port(module, _load_torch_file(str(path)))
    return policy
