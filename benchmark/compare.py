"""The numbers that decide ``correct``: what the timed path produced against
what the plain reference produces from the same inputs, weights and draws.

Training (the first three optimizer steps of the timed path, which set-up
runs through the window's own call on three distinct batches):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (read back from
  AdamW's first moment after one step), by the worst leaf: the gap between
  the program's norm of the leaf and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of each leaf's change over the three steps, as
  it stood before step 4. Leaves whose reference gradient is under a
  thousandth of the median leaf's (zero but for rounding, such as a key's
  bias under softmax, whose Adam update is round-off amplified) are left
  out; so are the decoder layers the model never runs, whose gradient is
  exactly zero.

Serving: ``action_gap``, over a sample of the window's requests, the
largest gap of an action from the reference's over the largest reference
action of its request.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["leaf_norms", "leaf_gap", "train_checks", "action_gap", "SMALL_GRAD"]

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm: a leaf that does not move


def _worst(pairs):
    """The largest (value, label); a value that is not a number is the
    worst of all (Python's max would pass over it)."""
    pairs = list(pairs)
    bad = [p for p in pairs if not math.isfinite(p[0])]
    return (math.inf, bad[0][1]) if bad else max(pairs)


def leaf_norms(leaves: dict, device) -> dict:
    return {n: float(t.to(device, torch.float64).norm()) for n, t in leaves.items()}


def leaf_gap(prog: dict, ref: dict, names) -> tuple[float, str]:
    """(max over ``names`` of |prog - ref| / max(ref, median of ref), the
    leaf where it is)."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return _worst((abs(prog[n] - ref[n]) / max(ref[n], median), n) for n in names)


def train_checks(prog: dict, ref: dict, device, where: dict | None = None) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "grads": {leaf: tensor},
    "deltas": {leaf: tensor}} -> {number: value}; ``where``, if given,
    gets the leaf of each leaf-wise number."""
    loss_gap = _worst((abs(p - r) / abs(r), i)
                      for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])))[0]
    g_prog, g_ref = leaf_norms(prog["grads"], device), leaf_norms(ref["grads"], device)
    live = [n for n in g_ref if g_ref[n] > 0.0]
    if not live:
        raise ValueError("the reference's first gradient is zero everywhere")
    median = statistics.median(g_ref[n] for n in live)
    moving = [n for n in live if g_ref[n] >= SMALL_GRAD * median]
    d_prog, d_ref = leaf_norms(prog["deltas"], device), leaf_norms(ref["deltas"], device)
    grad_gap, grad_leaf = leaf_gap(g_prog, g_ref, live)
    update_gap, update_leaf = leaf_gap(d_prog, d_ref, moving)
    if where is not None:
        where.update(grad_gap=grad_leaf, update_gap=update_leaf)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}


def action_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.to(ref.device, torch.float64), ref.to(torch.float64)
    gap = float((prog - ref).abs().max() / ref.abs().max())
    return gap if math.isfinite(gap) else math.inf
