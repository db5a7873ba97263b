"""Pretrained encoder weights from a local file (port of
``pointcloudmatters_tpu/models/components/pretrained.py``).

:func:`load_pretrained_into` runs right after a policy's weights are drawn
(``train.instantiate_model``): it walks the policy's modules, and for each
one whose ``pretrained_path`` is set it reads that local file (no download)
and copies the checkpoint in with its family's mapping. A path that does not
exist logs a warning and keeps the drawn weights, as in JAX. The families:
SpUNet (PonderV2 checkpoints), ``ResNetTorchVision`` / ``R3MResNet``
(torchvision and R3M state dicts), ``ViT`` / ``MAEViT`` / ``VC1ViT`` (timm,
MAE and VC-1 ones) and ``MultiViTModel`` / ``MultiMAEModel`` (EPFL
MultiMAE). As in JAX, only ``pretrained_path`` is read: the MultiViT
configs' ``ckpt_path`` is not (``img_encoder/multivit.py``).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.img_encoder.multivit import (
    MultiViTModel,
    load_torch_multimae_state_dict,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import (
    ResNetTorchVision,
    load_torch_state_dict,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder.vit import (
    ViT,
    load_torch_vit_state_dict,
)
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


_FAMILIES = ((SpUNet, load_ponderv2_weights), (ResNetTorchVision, load_torch_state_dict),
             (ViT, load_torch_vit_state_dict), (MultiViTModel, load_torch_multimae_state_dict))


def _port(module: nn.Module, state_dict: dict) -> None:
    for family, load in _FAMILIES:
        if isinstance(module, family):
            load(module, state_dict)
            return
    raise NotImplementedError(
        f"no pretrained-weight family for {type(module).__name__}: the port loads "
        + ", ".join(f.__name__ for f, _ in _FAMILIES) + " and their subclasses")


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
