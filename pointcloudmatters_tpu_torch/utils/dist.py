"""Data parallelism of the port (port of ``pointcloudmatters_tpu/utils/dist.py``):
one process a card, joined by ``torch.distributed``.

The JAX package trains one program over a mesh of devices, whose step is the
global batch's (GSPMD). Here each process holds the whole model and its own
block of every global batch; the trainer sums gradients, the batch norms
their statistics, and the metrics their states over the processes' default
group, so that a step at world size W over W local batches computes what a
step at world size 1 computes over their concatenation.

Rank and world size are the default group's when one is initialised, else
(0, 1). :func:`init_dist` joins the group the environment describes:
torchrun's ``RANK`` / ``LOCAL_RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``, or SLURM's ``SLURM_PROCID`` / ``SLURM_LOCALID`` /
``SLURM_NTASKS`` / ``SLURM_NODELIST`` (the first host of the node list, and
``MASTER_PORT`` or 29500, as the JAX package reads them). The backend is NCCL
for a CUDA device and gloo for the CPU; a world of one creates no group.

The training path uses two collectives, ``all_reduce`` and ``broadcast``:
gloo takes CUDA tensors for both, so that a world of two processes may share
one card under a gloo group (``chip_smoke.py`` phase 12; NCCL refuses two
ranks on one card).
"""

from __future__ import annotations

import functools
import os
import pickle
import socket
import subprocess
import sys
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "get_rank", "get_world_size", "is_initialized", "is_main_process", "local_rank",
    "barrier", "rank_zero_only", "all_reduce_mean", "merge_results_dist", "process_env",
    "init_dist", "destroy", "requested_world", "free_port", "spawn_ranks", "all_reduce_sum",
    "all_reduce_", "broadcast_", "broadcast_flag",
]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def local_rank() -> int:
    """This process's card on its machine: torchrun's ``LOCAL_RANK``, else
    SLURM's ``SLURM_LOCALID``, else 0."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", 0)))


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def rank_zero_only(fn):
    """``fn`` run on rank 0 only; elsewhere the call returns None."""

    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        return fn(*args, **kwargs) if get_rank() == 0 else None

    return wrap


def _group_device() -> torch.device:
    """Where the default group's collectives take tensors: the current card
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(value) -> np.ndarray:
    """The mean over the ranks of a host scalar or array (the reference's
    ``dist.all_reduce`` mean, ``common_utils.py:34-40``)."""
    value = np.asarray(value, dtype=np.float64)
    if get_world_size() == 1:
        return value
    t = torch.from_numpy(value.copy()).to(_group_device())
    dist.all_reduce(t)
    return t.cpu().numpy() / get_world_size()


def merge_results_dist(results: list, tmpdir: str) -> Optional[list]:
    """Each rank's ``results`` pickled into ``tmpdir``; rank 0 returns their
    concatenation in rank order, the others None (the reference's
    ``common_utils.py:260-283``)."""
    os.makedirs(tmpdir, exist_ok=True)
    rank, world = get_rank(), get_world_size()
    with open(os.path.join(tmpdir, f"result_part_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    barrier()
    if rank != 0:
        return None
    merged: list = []
    for r in range(world):
        with open(os.path.join(tmpdir, f"result_part_{r}.pkl"), "rb") as f:
            merged.extend(pickle.load(f))
    return merged


def process_env(environ: Optional[Mapping] = None) -> Optional[dict]:
    """The group the environment describes, ``{rank, local_rank, world,
    addr, port}``: torchrun's variables, else SLURM's; None with neither."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" in env and "RANK" in env:
        return {"rank": int(env["RANK"]), "local_rank": int(env.get("LOCAL_RANK", 0)),
                "world": int(env["WORLD_SIZE"]),
                "addr": env.get("MASTER_ADDR", "127.0.0.1"),
                "port": int(env.get("MASTER_PORT", 29500))}
    if "SLURM_NTASKS" in env and "SLURM_PROCID" in env:
        node_list = env.get("SLURM_NODELIST", "localhost")
        return {"rank": int(env["SLURM_PROCID"]), "local_rank": int(env.get("SLURM_LOCALID", 0)),
                "world": int(env["SLURM_NTASKS"]),
                "addr": node_list.split(",")[0].replace("[", "").split("-")[0],
                "port": int(env.get("MASTER_PORT", 29500))}
    return None


def init_dist(device_type: str, environ: Optional[Mapping] = None) -> int:
    """Join the group that ``environ`` (the process's environment by
    default) describes, NCCL for ``device_type`` ``"cuda"`` (its card made
    the current one) and gloo otherwise; the world size. Joins nothing when a
    default group is initialised already (its size is returned), when the
    environment describes no group, or a world of one."""
    if is_initialized():
        return get_world_size()
    env = process_env(environ)
    if env is None or env["world"] == 1:
        return 1
    backend = "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(env["local_rank"])
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{env['addr']}:{env['port']}",
                            rank=env["rank"], world_size=env["world"])
    return env["world"]


def destroy() -> None:
    """Leave the default group, if one is initialised."""
    if is_initialized():
        dist.destroy_process_group()


def requested_world(accelerator: str, devices: Any, num_nodes: int = 1) -> int:
    """The processes a trainer's keys ask for, one a device, as Lightning
    counts them: ``devices`` (an int, or ``"auto"`` / -1 for every card of
    the machine, one CPU process for ``accelerator="cpu"``) times
    ``num_nodes`` (``num_nodes`` on a machine without a card, where the
    trainer raises). Raises where ``devices`` asks for more cards than the
    machine has, and where ``num_nodes`` > 1 is asked of a process that
    torchrun or SLURM did not start."""
    if num_nodes > 1 and process_env() is None:
        raise ValueError(f"num_nodes={num_nodes} needs the processes of every node: start "
                         "them with torchrun or srun")
    auto = devices in ("auto", -1, "-1", None)
    if accelerator == "cpu":
        return (1 if auto else int(devices)) * num_nodes
    if not torch.cuda.is_available():
        return num_nodes  # the trainer raises that there is no card
    cards = torch.cuda.device_count()
    n = cards if auto else int(devices)
    if n > cards:
        raise ValueError(f"devices={devices} asks for {n} cards and this machine has {cards}")
    return max(1, n) * num_nodes


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: Sequence[str], world: int
                ) -> tuple[dict, list[subprocess.Popen]]:
    """Ranks 1 .. ``world`` - 1 of a world on this machine, each running
    ``python -m module argv`` with torchrun's variables set, as Lightning's
    subprocess launcher starts them for the reference; returns the variables
    of rank 0 (the caller, for :func:`init_dist`) and the processes."""
    base = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
            "WORLD_SIZE": str(world)}
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env={**os.environ, **base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(1, world)]
    return {**base, "RANK": "0", "LOCAL_RANK": "0"}, procs


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, forward and backward: each rank's input
    contributes to every rank's output, so each output's gradient comes back
    summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the default group for None), through
    which gradients flow (summed over the ranks in turn)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_(tensors: Sequence[torch.Tensor], op=dist.ReduceOp.SUM) -> None:
    """Reduce ``tensors`` of one dtype and device in place over the default
    group, in one collective on a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s ``tensors`` copied in place on every rank, one
    broadcast a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        with torch.no_grad():
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank (``flag`` itself in a world of
    one)."""
    if not is_initialized():
        return flag
    t = torch.full((1,), int(flag), dtype=torch.int32, device=_group_device())
    dist.broadcast(t, src)
    return bool(t.item())
