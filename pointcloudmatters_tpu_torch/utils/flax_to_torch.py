"""JAX variables -> the port's ``state_dict`` (the inverse of
``pointcloudmatters_tpu/utils/torch_layouts.py:47-102``).

Input is the flax ``variables`` of a JAX model, ``{"params": ...,
"batch_stats": ...}`` as nested mappings of arrays (numpy, or anything
``np.asarray`` takes). Paths map by joining with ``.`` and turning
``layers_<i>`` into ``layers.<i>`` (an ``nn.ModuleList``). Leaves map as:

- Dense ``kernel`` (in, out)               -> Linear ``weight`` (out, in)
- attention ``query``/``key``/``value`` kernel (D, H, dh), bias (H, dh)
                                            -> Linear weight (H*dh, D), bias (H*dh,)
- attention ``out`` kernel (H, dh, D)      -> Linear weight (D, H*dh)
- LayerNorm ``scale``/``bias``             -> ``weight``/``bias``
- batch norms (modules with ``batch_stats``): ``scale``/``bias`` parameters
  and ``mean``/``var`` buffers keep their names
- top-level embeddings ``cls_embed``, ``query_embed``,
  ``additional_pos_embed`` keep theirs

Anything else is an error, and so is a key or shape the target state dict
does not have or lacks.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["flax_to_torch"]

_EMBEDDINGS = ("cls_embed", "query_embed", "additional_pos_embed")
_QKV = ("query", "key", "value")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _key(path: tuple) -> str:
    return re.sub(r"(^|\.)layers_(\d+)(?=\.|$)", r"\1layers.\2", ".".join(path))


def _param(path: tuple, leaf: np.ndarray, norms: set) -> tuple[str, np.ndarray]:
    *mod, name = path
    mod = tuple(mod)
    last = mod[-1] if mod else None
    if not mod and name in _EMBEDDINGS:
        return name, leaf
    if name == "kernel" and leaf.ndim == 2:
        return _key(mod + ("weight",)), leaf.T
    if name == "kernel" and leaf.ndim == 3 and last in _QKV:
        return _key(mod + ("weight",)), leaf.reshape(leaf.shape[0], -1).T
    if name == "kernel" and leaf.ndim == 3 and last == "out":
        return _key(mod + ("weight",)), leaf.reshape(-1, leaf.shape[-1]).T
    if name == "bias":
        return _key(path), leaf.reshape(-1) if last in _QKV else leaf
    if name == "scale":
        return _key(path if mod in norms else mod + ("weight",)), leaf
    raise KeyError(f"unmapped JAX parameter {'/'.join(path)} "
                   f"of shape {leaf.shape}")


def flax_to_torch(variables: Mapping, target: Mapping[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
    """Convert ``variables`` to a state dict with exactly the keys and shapes
    of ``target`` (a ``state_dict()`` of the port's model).

    Raises ``KeyError`` on an unmapped, missing or unexpected key and
    ``ValueError`` on a shape mismatch."""
    stats = {p: np.asarray(v) for p, v in
             _flatten(variables.get("batch_stats", {})).items()}
    norms = {p[:-1] for p in stats}
    out: dict[str, np.ndarray] = {}
    for path, leaf in stats.items():
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"unmapped JAX batch statistic {'/'.join(path)}")
        out[_key(path)] = leaf
    for path, leaf in _flatten(variables["params"]).items():
        key, value = _param(path, np.asarray(leaf), norms)
        out[key] = value
    missing = sorted(set(target) - set(out))
    unexpected = sorted(set(out) - set(target))
    if missing or unexpected:
        raise KeyError(f"JAX variables do not match the model: missing "
                       f"{missing}, unexpected {unexpected}")
    bad = [f"{k}: {out[k].shape} vs {tuple(target[k].shape)}" for k in out
           if tuple(out[k].shape) != tuple(target[k].shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
