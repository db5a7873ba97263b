"""The reference's first three optimizer steps: the loss of each batch,
its gradient with respect to the f32 master weights, and AdamW under
OneCycleLR on those masters, as a mixed-precision trainer runs them (the
forward on a cast of the masters and of the batch's floating arrays)."""

from __future__ import annotations

from typing import Callable

import torch

from benchmark.reference import plain

__all__ = ["cast_tree", "three_steps"]


def cast_tree(tree, cast: Callable):
    """Every floating tensor of a nested dict through ``cast``; the rest as is."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, cast) for k, v in tree.items()}
    return cast(tree) if torch.is_tensor(tree) and tree.is_floating_point() else tree


def three_steps(loss_fn: Callable, init: dict, batches: list, rngs: dict, opt: dict,
                sched: dict, total_steps: int, cast: Callable) -> dict:
    """``loss_fn(P, batch, rngs)`` over ``batches`` in turn from the f32
    weights ``init``, each step's forward on ``cast`` of the weights and of
    the batch -> {"losses", "grads" (the first step's), "deltas" (the
    weights' change over the steps)}."""
    params = {n: t.detach().clone().requires_grad_(True) for n, t in init.items()}
    adam = plain.AdamW(params, opt)
    losses, first = [], None
    for i, batch in enumerate(batches):
        P = {n: cast(p) for n, p in params.items()}
        loss = loss_fn(P, cast_tree(batch, cast), rngs).to(torch.float32)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), got)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        lr, beta1 = plain.one_cycle(i, total_steps, sched, float(opt["lr"]))
        adam.step(grads, lr, beta1)
        del P, loss, got, grads
    with torch.no_grad():
        deltas = {n: params[n] - init[n].to(params[n].device) for n in params}
    return {"losses": losses, "grads": first, "deltas": deltas}
