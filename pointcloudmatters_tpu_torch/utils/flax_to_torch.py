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
- Conv ``kernel`` (k, in, out)             -> Conv1d ``weight`` (out, in, k)
- Conv ``kernel`` (kh, kw, in, out)        -> Conv2d ``weight`` (out, in, kh, kw)
  (the image encoders' convolutions and patch embeddings)
- ConvTranspose ``kernel`` (k, in, out)    -> ConvTranspose1d ``weight`` (in, out, k),
  flipped in time (flax's ``transpose_kernel=False`` correlates where torch
  convolves): the modules of the target that are ``nn.ConvTranspose1d``
- LayerNorm and GroupNorm ``scale``/``bias`` -> ``weight``/``bias``
- batch norms (modules with ``batch_stats``): ``scale``/``bias`` parameters
  and ``mean``/``var`` buffers keep their names; a ``FrozenBatchNorm``'s
  four ``batch_stats`` (its affine included) are buffers of those names
- top-level embeddings ``cls_embed``, ``query_embed``,
  ``additional_pos_embed``, the state-only ACT's ``state_pos_embed`` and
  ``TransformerForDiffusion``'s ``pos_emb`` / ``cond_pos_emb`` keep theirs, and so do the image encoders'
  parameters owned by a module itself at any depth (``pos_embed``,
  ``cls_token``, ``global_tokens``, ``row_embed``, ``col_embed``)
- SpUNet's convolution planes (``conv_input_weight``, ``down<s>_weight``,
  ``up<s>_weight``, ``final_weight``, ``<enc|dec><s>_block<i>_<conv1|conv2|proj>``,
  (K, Ci, Co)) and ``final_bias`` keep their names and layout; a
  ``PDBatchNorm``'s branches ``bns_<i>`` become ``bns.<i>`` (an
  ``nn.ModuleList``), and an ``Embed``'s ``embedding`` is the
  ``nn.Embedding``'s ``weight``
- the Diffusion Policy's image encoder: a shared ``rgb_model`` keeps its
  name; a per-key copy, ``key_models_<key>`` in JAX's tree (flax names a
  module held in a dict by the attribute, not by its ``clone`` name), is
  ``model_<key>``, the name ``scripts/port_reference_ckpt.py`` gives it too

Anything else is an error, and so is a key or shape the target state dict
does not have or lacks.

:func:`jax_checkpoint_to_torch` carries a whole JAX checkpoint (the tree
``Trainer.restore_checkpoint`` of the JAX package reads back) into the port's
checkpoint dict: weights, batch statistics, the AdamW moments and count, the
schedule's count, ``optax.MultiSteps``' mean and mini-step, step and epoch,
and the extras (the Diffusion Policy's normalizer), as tensors.
"""

from __future__ import annotations

import copy
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

__all__ = ["flax_to_torch", "jax_param_paths", "jax_checkpoint_to_torch", "arrays_to_tensors"]

_EMBEDDINGS = ("cls_embed", "query_embed", "additional_pos_embed", "state_pos_embed",
               "pos_emb", "cond_pos_emb")
_OWN = ("pos_embed", "cls_token", "global_tokens", "row_embed", "col_embed")
_QKV = ("query", "key", "value")
_PLANE = re.compile(r"(conv_input_weight|down\d+_weight|up\d+_weight|final_weight|final_bias"
                    r"|(enc|dec)\d+_block\d+_(conv1|conv2|proj))")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _key(path: tuple) -> str:
    key = re.sub(r"(^|\.)(layers|bns)_(\d+)(?=\.|$)", r"\1\2.\3", ".".join(path))
    return re.sub(r"(^|\.)key_models_", r"\1model_", key)


def _unkey(key: str) -> str:
    """The JAX module path of a torch module path (``_key``'s inverse)."""
    key = re.sub(r"(^|\.)(layers|bns)\.(\d+)(?=\.|$)", r"\1\2_\3", key)
    return re.sub(r"(^|\.)model_", r"\1key_models_", key)


_KERNELS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


def jax_param_paths(model: nn.Module) -> dict[str, str]:
    """``{torch parameter name: JAX path string}`` of the port's model: the
    path ``jax.tree_util`` gives the parameter in the JAX model's params
    tree, ``/``-joined (``transformer/encoder/layers_0/self_attn/query/
    kernel``), which keyword-matched parameter groups and layer decay read
    (``utils/optimizer.py``). The inverse of :func:`flax_to_torch`'s name
    map: a Linear's or convolution's ``weight`` is ``kernel``, a LayerNorm's
    or GroupNorm's ``scale``, an Embedding's ``embedding``; every other
    leaf keeps its name."""
    out = {}
    for name, _ in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(mod_name) if mod_name else model
        if leaf == "weight":
            if isinstance(module, _KERNELS):
                leaf = "kernel"
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                leaf = "scale"
            elif isinstance(module, nn.Embedding):
                leaf = "embedding"
        out[name] = "/".join(filter(None, _unkey(mod_name).split(".") + [leaf]))
    return out


def _param(path: tuple, leaf: np.ndarray, norms: set, transposed: set
           ) -> tuple[str, np.ndarray]:
    *mod, name = path
    mod = tuple(mod)
    last = mod[-1] if mod else None
    if not mod and name in _EMBEDDINGS:
        return name, leaf
    if _PLANE.fullmatch(name) or name in _OWN:
        return _key(path), leaf
    if name == "kernel" and leaf.ndim == 4:
        return _key(mod + ("weight",)), leaf.transpose(3, 2, 0, 1)
    if name == "embedding" and leaf.ndim == 2:
        return _key(mod + ("weight",)), leaf
    if name == "kernel" and leaf.ndim == 2:
        return _key(mod + ("weight",)), leaf.T
    if name == "kernel" and leaf.ndim == 3 and last in _QKV:
        return _key(mod + ("weight",)), leaf.reshape(leaf.shape[0], -1).T
    if name == "kernel" and leaf.ndim == 3 and last == "out":
        return _key(mod + ("weight",)), leaf.reshape(-1, leaf.shape[-1]).T
    if name == "kernel" and leaf.ndim == 3:
        if _key(mod) in transposed:
            return _key(mod + ("weight",)), leaf[::-1].transpose(1, 2, 0)
        return _key(mod + ("weight",)), leaf.transpose(2, 1, 0)
    if name == "bias":
        return _key(path), leaf.reshape(-1) if last in _QKV else leaf
    if name == "scale":
        return _key(path if mod in norms else mod + ("weight",)), leaf
    raise KeyError(f"unmapped JAX parameter {'/'.join(path)} "
                   f"of shape {leaf.shape}")


def flax_to_torch(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert ``variables`` to a state dict with exactly the keys and shapes
    of ``model.state_dict()``. The model, not its state dict, is what is
    given: a transposed convolution's kernel has the shape of a plain one
    when its in and out widths are equal, and only the module's type tells
    them apart.

    Raises ``KeyError`` on an unmapped, missing or unexpected key and
    ``ValueError`` on a shape mismatch."""
    if not isinstance(model, nn.Module):
        raise TypeError(f"flax_to_torch takes the port's model, not a {type(model).__name__}")
    transposed = {name for name, m in model.named_modules()
                  if isinstance(m, nn.ConvTranspose1d)}
    target = model.state_dict()
    stats = {p: np.asarray(v) for p, v in
             _flatten(variables.get("batch_stats", {})).items()}
    norms = {p[:-1] for p in stats}
    out: dict[str, np.ndarray] = {}
    for path, leaf in stats.items():
        # a FrozenBatchNorm keeps its affine in batch_stats too
        if path[-1] not in ("mean", "var", "scale", "bias"):
            raise KeyError(f"unmapped JAX batch statistic {'/'.join(path)}")
        out[_key(path)] = leaf
    for path, leaf in _flatten(variables["params"]).items():
        key, value = _param(path, np.asarray(leaf), norms, transposed)
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


def _plain(tree: Any) -> Any:
    """Named tuples -> dicts, tuples -> lists, arrays -> numpy: the form an
    Orbax checkpoint restored without a template has."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree if tree is None or isinstance(tree, (int, float)) else np.asarray(tree)


def arrays_to_tensors(tree: Any) -> Any:
    """Every numpy array of a nested dict or list as a CPU tensor (what a
    checkpoint file read with ``weights_only`` holds); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: arrays_to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [arrays_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


def _nodes(tree: Any, keys: set) -> list[dict]:
    """Every dict of ``tree`` whose keys are exactly ``keys``, in order."""
    if isinstance(tree, dict):
        if set(tree) == keys:
            return [tree]
        return [n for v in tree.values() for n in _nodes(v, keys)]
    if isinstance(tree, list):
        return [n for v in tree for n in _nodes(v, keys)]
    return []


def _one(tree: Any, keys: set, what: str) -> dict | None:
    found = _nodes(tree, keys)
    if len(found) > 1:
        raise ValueError(f"the JAX optimizer state holds {len(found)} {what} states")
    return found[0] if found else None


def _present(tree: Any) -> Any:
    """``tree`` without the leaves an ``optax.masked`` group leaves out
    (``MaskedNode``: an empty dict once restored, or None), and without the
    dicts that held only those."""
    if isinstance(tree, dict):
        kept = {k: _present(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items()
                if not (v is None or (isinstance(v, dict) and not v))}
    return tree


def _merge(trees: list) -> dict:
    """One nested dict of the disjoint nested dicts ``trees``."""
    out: dict = {}
    for tree in trees:
        for k, v in tree.items():
            out[k] = _merge([out[k], v]) if isinstance(v, dict) and k in out else v
    return out


def _optimizer_state(opt: Any, optimizer, name_of: dict, as_torch, param_keys: set) -> dict:
    """The torch ``optimizer``'s per-parameter state (indexed over its
    groups' parameters in order) of the JAX optimizer state ``opt``: Adam's
    moments, SGD's momentum traces, or nothing for SGD without momentum.
    ``param_keys`` are the top-level keys of the parameter tree, which tell
    a parameter tree inside ``opt`` from the optimizer's own nodes."""
    groups = optimizer.param_groups
    adams = _nodes(opt, {"count", "mu", "nu"})
    traces = _nodes(opt, {"trace"})
    if isinstance(optimizer, torch.optim.SGD):
        found, kind = traces, "momentum trace"
        if not any(g["momentum"] for g in groups) and not adams:
            if traces:
                raise ValueError("the JAX optimizer state holds momentum traces and the "
                                 "module's SGD has no momentum")
            return {}
    else:
        found, kind = adams, "Adam"
    if not found:
        held = sorted({"/".join(sorted(k)) for k in _state_nodes(opt, param_keys) if k})
        raise NotImplementedError(
            f"only Adam-family (AdamW, Adam) and SGD optimizer states convert: the JAX state "
            f"holds nodes of {held or 'no state'} and the module's optimizer is "
            f"{type(optimizer).__name__}")
    if len(found) != len(groups):
        raise ValueError(f"the JAX optimizer state holds {len(found)} {kind} states and the "
                         f"module's optimizer {len(groups)} parameter groups")
    if kind == "Adam":
        mu = as_torch(_merge([_present(a["mu"]) for a in found]))
        nu = as_torch(_merge([_present(a["nu"]) for a in found]))
    else:
        trace = as_torch(_merge([_present(t["trace"]) for t in found]))
    state, i = {}, 0
    for group, node in zip(groups, found):
        for p in group["params"]:
            n = name_of[id(p)]
            state[i] = ({"step": torch.tensor(float(node["count"]), dtype=torch.float32),
                         "exp_avg": mu[n], "exp_avg_sq": nu[n]} if kind == "Adam"
                        else {"momentum_buffer": trace[n]})
            i += 1
    return state


def _state_nodes(tree: Any, param_keys: set) -> list[frozenset]:
    """The key sets of the optimizer's own dicts in ``tree``, not descending
    into a parameter tree (a dict with a key of ``param_keys``)."""
    if isinstance(tree, dict):
        if set(tree) & param_keys:
            return []
        return [frozenset(tree)] + [k for v in tree.values() for k in _state_nodes(v, param_keys)]
    if isinstance(tree, list):
        return [k for v in tree for k in _state_nodes(v, param_keys)]
    return []


def jax_checkpoint_to_torch(restored: Mapping, module) -> dict:
    """The port's checkpoint dict (``trainer.py``) of a JAX checkpoint.

    ``restored`` is the JAX checkpoint's tree (``params``, ``batch_stats``,
    ``step``, ``epoch`` and, unless it holds weights only, ``opt_state``),
    restored with or without a template, as arrays numpy takes. ``module``
    is the port's ``BCModule`` with its optimizer built
    (``Trainer.setup``): its policy gives the layout, its optimizer the
    parameter groups. AdamW's ``mu``/``nu``/``count`` become the optimizer's
    ``exp_avg``/``exp_avg_sq``/``step`` (through the same layout rules as
    the parameters), the schedule's count its ``last_epoch``, and
    ``MultiSteps``' ``acc_grads``/``mini_step`` the gradient mean's. SGD's
    ``optax.trace`` (``{"trace": ...}``) becomes torch SGD's
    ``momentum_buffer`` by the same rules: with dampening 0 torch's ``buf =
    m buf + g`` is optax's ``t = g + m t``, Nesterov's update ``g + m buf``
    alike in both, coupled weight decay added to ``g`` before both, and a
    zero trace steps as torch's first ``buf = g``; SGD without momentum has
    no state in either package. Under keyword-matched ``param_dicts``
    (``optax.multi_transform``) each group holds an Adam state, or a trace,
    over its own parameters, which the optimizer's group of the same index
    takes; the groups' schedules count alike. The
    JAX ``rng`` key has no counterpart (the port draws its dropout bits
    another way) and is left out, so the restoring trainer keeps the streams
    it seeded from ``module.seed``."""
    if module.optimizer is None:
        raise ValueError("build the module's optimizer before converting (Trainer.setup)")
    restored = _plain(restored)
    policy = module.policy
    names = [n for n, _ in policy.named_parameters()]
    stats = restored.get("batch_stats") or {}

    def as_torch(tree: Mapping) -> dict[str, torch.Tensor]:
        return flax_to_torch({"params": tree, "batch_stats": stats}, policy)

    state = as_torch(restored["params"])
    out = {"params": {n: state[n] for n in names},
           "batch_stats": {k: v for k, v in state.items() if k not in names},
           "step": int(restored["step"]), "epoch": int(restored["epoch"])}
    if restored.get("extras"):
        out["extras"] = arrays_to_tensors(restored["extras"])
    opt = restored.get("opt_state")
    if opt is None:
        return out
    name_of = {id(p): n for n, p in policy.named_parameters()}
    optimizer = copy.deepcopy(module.optimizer.state_dict())
    optimizer["state"] = _optimizer_state(opt, module.optimizer, name_of, as_torch,
                                          set(restored["params"]))
    schedules = _nodes(opt, {"count"})
    if len({int(s["count"]) for s in schedules}) > 1:
        raise ValueError("the JAX optimizer state's schedules disagree on their count")
    if (not schedules) != (module.scheduler is None):
        raise ValueError("the JAX checkpoint and the module disagree on a learning-rate schedule")
    multi = _one(opt, {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                       "skip_state"}, "MultiSteps")
    if (multi is None) != (module.gradient_mean is None):
        raise ValueError("the JAX checkpoint and the module disagree on gradient accumulation")
    trainable = [n for n, p in policy.named_parameters() if p.requires_grad]
    out["opt_state"] = {
        "optimizer": optimizer,
        "scheduler": None if not schedules else {"last_epoch": int(schedules[0]["count"])},
        "gradient_mean": None if multi is None else {
            "mini_step": int(multi["mini_step"]),
            "acc": [as_torch(multi["acc_grads"])[n] for n in trainable]},
    }
    return out
