#!/usr/bin/env python3
"""A port model's state in the form of a JAX checkpoint restored without a
template (nested dicts of numpy arrays), the inverse of
``pointcloudmatters_tpu_torch.utils.flax_to_torch.flax_to_torch``. For tests
and ``chip_smoke.py`` phase 19 (e), which hand
``jax_checkpoint_to_torch`` a JAX-form checkpoint written from a port
module; imports torch and the port, nothing of JAX::

    from tools.jax_form import torch_to_flax
    variables = torch_to_flax(policy)                    # {"params", "batch_stats"}
    trace = torch_to_flax(policy, {name: momentum_buffer, ...})  # a params tree
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from pointcloudmatters_tpu_torch.models.components.act.transformer import MultiHeadAttention
from pointcloudmatters_tpu_torch.utils.flax_to_torch import _unkey, jax_param_paths


def _flax_leaf(module: nn.Module, parent: Optional[nn.Module], jax_leaf: str,
               value: np.ndarray) -> np.ndarray:
    """A port tensor in the layout JAX keeps it in (the inverse of
    ``flax_to_torch._param``): a convolution's kernel channel-last, a
    linear's ``(in, out)``, an attention projection's ``(D, H, dh)``
    (query, key, value) or ``(H, dh, D)`` (out) with its bias ``(H, dh)``."""
    heads = parent.nhead if isinstance(parent, MultiHeadAttention) else None
    if jax_leaf == "kernel":
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)
        if value.ndim == 3:
            if isinstance(module, nn.ConvTranspose1d):
                return value.transpose(2, 0, 1)[::-1]
            return value.transpose(2, 1, 0)
        if heads and module is parent.out:
            return value.T.reshape(heads, -1, value.shape[0])
        if heads:
            return value.T.reshape(value.shape[1], heads, -1)
        return value.T
    if jax_leaf == "bias" and heads and module is not parent.out:
        return value.reshape(heads, -1)
    return value


def torch_to_flax(model: nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> dict:
    """The port model's state in the form of JAX's variables, as an Orbax
    checkpoint restored without a template holds them (nested dicts of
    numpy arrays): ``{"params": ..., "batch_stats": ...}``, which
    ``flax_to_torch`` maps back bit for bit. With ``tensors`` (by
    parameter name, such as an optimizer's per-parameter buffers) the
    params tree of those instead, in the parameters' layouts."""
    names = dict(model.named_parameters())
    paths = jax_param_paths(model)
    source = dict(tensors) if tensors is not None else model.state_dict()
    params: dict = {}
    stats: dict = {}
    for name, value in source.items():
        array = np.array(value.detach().cpu().numpy(), order="C")
        if name in names:
            mod_name = name.rpartition(".")[0]
            module = model.get_submodule(mod_name) if mod_name else model
            parent_name = mod_name.rpartition(".")[0]
            parent = model.get_submodule(parent_name) if mod_name else None
            path = paths[name].split("/")
            leaf, tree = _flax_leaf(module, parent, path[-1], array), params
        elif tensors is None:
            path, leaf, tree = _unkey(name).split("."), array, stats
        else:
            raise KeyError(f"{name} is not a parameter of the model")
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = np.ascontiguousarray(leaf)
    return params if tensors is not None else {"params": params, "batch_stats": stats}
