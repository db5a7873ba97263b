"""Optimizers from ``{"type": ...}`` config dicts (port of
``pointcloudmatters_tpu/utils/optimizer.py``), on torch's own optimizers,
whose semantics the JAX chains were written to reproduce: ``SGD`` and
``Adam`` apply coupled L2 decay (added to the gradient), ``AdamW``
decoupled decay scaled by the learning rate.

Keyword-matched parameter groups (``param_dicts=[{"keyword": ..., "lr":
..., ...}]``) match each keyword against a parameter's JAX path string
(``backbone/mlp/layers_0/kernel``: ``/`` separators, flax's leaf names,
``utils/flax_to_torch.py`` ``jax_param_paths``), not torch's dotted name;
the first matching dict wins and an unmatched parameter stays in group 0,
the base configuration. A group's other keys override the base
configuration's, and its learning rate is the schedule's times
``lr / base_lr`` (its ``lr_scale``, which ``utils/scheduler.py``
``LRSchedule`` applies). Under ``OneCycleLR`` beta1 cycles in every Adam
group. A JAX ``optax.multi_transform`` over these groups is a torch
optimizer with one parameter group each, in the same order.

:func:`build_optimizer_v2` is the timm-style builder: no weight decay on
1-D parameters and listed names, and with ``layer_decay`` a per-layer scale
of the update (BEiT's layer-wise decay) from the same path strings.

:class:`GradientMean` is the gradient accumulation of ``optax.MultiSteps``
(``accumulate_grad_batches``).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Iterable, Optional, Sequence, Union

import torch
from torch import nn

from pointcloudmatters_tpu_torch.utils.flax_to_torch import jax_param_paths
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["OPTIMIZERS", "sgd", "adam", "adamw", "build_optimizer", "named_jax_parameters",
           "param_groups_weight_decay", "param_groups_layer_decay", "build_optimizer_v2",
           "clip_by_global_norm", "global_norm", "GradientMean"]

log = RankedLogger(__name__, rank_zero_only=True)

Params = Union[nn.Module, Mapping, Iterable]


def sgd(params, lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False, dampening: float = 0.0) -> torch.optim.SGD:
    """SGD with coupled L2 decay and ``optax.trace`` momentum (Nesterov's
    where asked and there is momentum); ``dampening`` is accepted and, as
    in JAX, not read."""
    del dampening
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum))


def adam(params, lr: float, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with coupled L2 decay."""
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def adamw(params, lr: float, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW: decoupled decay scaled by the learning rate."""
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


OPTIMIZERS: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "SGD": sgd, "Adam": adam, "AdamW": adamw}


def named_jax_parameters(params: Params) -> Optional[dict[str, torch.Tensor]]:
    """``{JAX path: parameter}`` of a module (through ``jax_param_paths``)
    or of a mapping already keyed by path; None for a bare iterable."""
    if isinstance(params, nn.Module):
        paths = jax_param_paths(params)
        return {paths[name]: p for name, p in params.named_parameters()}
    if isinstance(params, Mapping):
        return dict(params)
    return None


def build_optimizer(cfg: dict, params: Params,
                    param_dicts: Optional[Sequence[dict]] = None) -> torch.optim.Optimizer:
    """A torch optimizer from ``{"type": "AdamW", "lr": ..., ...}`` over
    ``params`` (a module, a ``{JAX path: parameter}`` mapping or an iterable
    of parameters), with the keyword-matched groups of ``param_dicts``
    (module doc), which need the paths. Every group carries ``lr_scale``."""
    cfg = dict(cfg)
    opt_type = cfg.pop("type")
    if opt_type not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported; options: {sorted(OPTIMIZERS)}")
    base_lr = float(cfg.pop("lr"))
    make = OPTIMIZERS[opt_type]
    if not param_dicts:
        tensors = (list(params.parameters()) if isinstance(params, nn.Module)
                   else list(params.values()) if isinstance(params, Mapping) else list(params))
        return make([{"params": tensors, "lr_scale": 1.0}], lr=base_lr, **cfg)
    named = named_jax_parameters(params)
    if named is None:
        raise ValueError("param_dicts needs the parameters' names: pass the module or a "
                         "{JAX path: parameter} mapping")
    labels = {}
    for path in named:
        labels[path] = next((i + 1 for i, pd in enumerate(param_dicts)
                             if pd["keyword"] in path), 0)
    groups = []
    for i, extra in enumerate([{}] + [dict(pd) for pd in param_dicts]):
        lr = float(extra.get("lr", base_lr))
        members = [path for path, label in labels.items() if label == i]
        log.info(f"Params Group {i} ({len(members)} tensors): {members[:8]}...")
        group = {**cfg, **{k: v for k, v in extra.items() if k not in ("keyword", "lr")}}
        if "betas" in group:
            group["betas"] = tuple(group["betas"])
        groups.append({"params": [named[p] for p in members], "lr": lr,
                       "lr_scale": lr / base_lr if base_lr else 1.0, **group})
    # an empty group is kept, so that group i is JAX's label i
    return make(groups, lr=base_lr, **cfg)


def param_groups_weight_decay(params: Params, weight_decay: float,
                              no_weight_decay_list: Sequence[str] = ()) -> dict[str, bool]:
    """``{JAX path: decays}``: no decay on 1-D parameters (biases, norms)
    and on the listed paths."""
    del weight_decay
    no_decay = set(no_weight_decay_list)
    return {path: not (p.ndim <= 1 or path in no_decay)
            for path, p in named_jax_parameters(params).items()}


def _layer_id_from_path(name: str, num_layers: int) -> int:
    """Embedding-like parameters 0, numbered blocks ``1 + index`` (at most
    ``num_layers - 1``), the rest ``num_layers - 1``."""
    if any(k in name for k in ("patch_embed", "cls_token", "pos_embed", "embedding",
                               "conv_input", "conv1/")):
        return 0
    m = re.search(r"(?:blocks?|layers?|encoder)[._/]?(\d+)", name)
    if m:
        return min(1 + int(m.group(1)), num_layers - 1)
    return num_layers - 1


def param_groups_layer_decay(params: Params, weight_decay: float = 0.05,
                             layer_decay: float = 0.75,
                             no_weight_decay_list: Sequence[str] = (),
                             num_layers: int = 14) -> tuple[dict[str, float], dict[str, bool]]:
    """(``{JAX path: scale}``, ``{JAX path: decays}``) of BEiT's layer-wise
    decay: a parameter of layer ``l`` scales by
    ``layer_decay ** (max_layer - l)``."""
    named = named_jax_parameters(params)
    layers = {path: _layer_id_from_path(path, num_layers) for path in named}
    max_layer = max(layers.values(), default=0)
    scales = {path: float(layer_decay ** (max_layer - lid)) for path, lid in layers.items()}
    return scales, param_groups_weight_decay(named, weight_decay, no_weight_decay_list)


def build_optimizer_v2(cfg: dict, params: Params, weight_decay: float = 0.0,
                       lr_schedule: Optional[Callable[[int], float]] = None, **kwargs):
    """The timm-style builder: ``cfg`` has ``type`` (AdamW, Adam or SGD),
    ``lr`` and optionally ``weight_decay``, ``layer_decay``,
    ``filter_bias_and_bn`` (default true) and the optimizer's keys.

    AdamW decays (decoupled) under the mask; SGD and Adam add the masked
    decay to the gradient; SGD's momentum is ``optax.trace`` (Nesterov's
    where asked). With ``layer_decay`` each parameter's update is scaled by
    its layer's scale after the learning rate. The torch optimizer holds
    one parameter group per (decays, scale), each with its ``lr_scale``.

    Returns ``(optimizer, schedule)``: with ``lr_schedule`` (a step ->
    learning rate function) an ``LRSchedule`` to step after each
    ``optimizer.step()``, else None."""
    from pointcloudmatters_tpu_torch.utils.scheduler import LRSchedule

    cfg = dict(cfg)
    opt_type = cfg.pop("type")
    layer_decay = cfg.pop("layer_decay", None)
    filter_bias_and_bn = cfg.pop("filter_bias_and_bn", True)
    cfg.pop("foreach", None)
    wd = float(cfg.pop("weight_decay", weight_decay) or 0.0)
    base_lr = float(cfg.pop("lr"))
    kwargs = {**cfg, **kwargs}
    named = named_jax_parameters(params)
    if named is None:
        raise ValueError("build_optimizer_v2 needs the parameters' names: pass the module or "
                         "a {JAX path: parameter} mapping")
    decays = {path: True for path in named}
    if wd and filter_bias_and_bn:
        decays = param_groups_weight_decay(named, wd)
    scales = {path: 1.0 for path in named}
    if layer_decay is not None:
        scales, decays = param_groups_layer_decay(named, weight_decay=wd,
                                                  layer_decay=float(layer_decay))
    name = (opt_type if isinstance(opt_type, str) else opt_type.__name__).lower()
    betas = tuple(kwargs.get("betas", (0.9, 0.999)))
    eps = kwargs.get("eps", 1e-8)
    if name == "adamw":
        make = lambda groups: torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=eps)  # noqa: E731
    elif name == "adam":
        make = lambda groups: torch.optim.Adam(groups, lr=base_lr, betas=betas, eps=eps)  # noqa: E731
    elif name == "sgd":
        momentum = kwargs.get("momentum") or 0.0
        nesterov = bool(kwargs.get("nesterov", False) and momentum)
        make = lambda groups: torch.optim.SGD(groups, lr=base_lr, momentum=momentum,  # noqa: E731
                                              nesterov=nesterov)
    else:
        raise KeyError(f"{opt_type} is not in the optimizers registry")
    groups: dict[tuple, dict] = {}
    for path, p in named.items():
        key = (decays[path], scales[path])
        if key not in groups:
            groups[key] = {"params": [], "weight_decay": wd if key[0] else 0.0,
                           "lr": base_lr * key[1], "lr_scale": key[1]}
        groups[key]["params"].append(p)
    optimizer = make(list(groups.values()))
    return optimizer, (None if lr_schedule is None else LRSchedule(optimizer, lr_schedule))


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
