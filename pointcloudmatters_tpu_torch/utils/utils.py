"""Run-lifecycle helpers (port of ``pointcloudmatters_tpu/utils/utils.py``):
seeding, the pre-run extras, the task wrapper, the optimized metric, and the
callbacks and loggers of a composed config."""

from __future__ import annotations

import functools
import os
import random
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.utils import config as config_engine
from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's default generators (the CPU's and
    every card's) and set ``PYTHONHASHSEED``. The training step's own
    streams are seeded from the module's ``seed`` (``BCModule.make_rngs``).

    Under data parallelism each rank seeds from ``(seed, rank)``, so that
    its samples' random draws (start steps, grid picks) are its own; rank 0
    seeds as a world of one does."""
    rank = dist.get_rank()
    if rank:
        seed = int(np.random.SeedSequence(seed % 2 ** 63, spawn_key=(rank,)).generate_state(1)[0])
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def print_config_tree(cfg: dict, indent: int = 0) -> None:
    """Plain-text config tree."""
    pad = "  " * indent
    for key, value in dict.items(cfg) if isinstance(cfg, dict) else []:
        if isinstance(value, dict):
            print(f"{pad}{key}:")
            print_config_tree(value, indent + 1)
        else:
            print(f"{pad}{key}: {value}")


def extras(cfg: dict) -> None:
    """Pre-run niceties: warnings filter, tag enforcement, config tree (on
    rank 0)."""
    ex = cfg.get("extras") or {}
    if ex.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags") and not cfg.get("tags"):
        raise ValueError("Specify tags before launching (enforce_tags=true)")
    if ex.get("print_config", True) and dist.is_main_process():
        print_config_tree(cfg)


def task_wrapper(task_func: Callable) -> Callable:
    """Logs a failure and the output directory, and re-raises, so that a
    multirun surfaces a failed job."""

    @functools.wraps(task_func)
    def wrap(cfg: dict):
        try:
            metric_dict, object_dict = task_func(cfg)
        except Exception:
            log.exception("task failed")
            raise
        finally:
            out = config_engine.select(cfg, "paths.output_dir")
            log.info(f"Output dir: {out}")
        return metric_dict, object_dict

    return wrap


def get_metric_value(metric_dict: dict, metric_name: Optional[str]):
    """The value of the sweep's optimized metric, as a float; None without
    one."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(f"Metric '{metric_name}' not found in {sorted(metric_dict)}")
    return float(metric_dict[metric_name])


def _instantiate_group(group_cfg: Any, kind: str) -> list:
    objects = []
    for node in dict.values(group_cfg or {}):
        if isinstance(node, dict) and "_target_" in node:
            log.info(f"Instantiating {kind} <{node['_target_']}>")
            objects.append(config_engine.instantiate(node))
    return objects


def instantiate_callbacks(callbacks_cfg: Any) -> list:
    return _instantiate_group(callbacks_cfg, "callback")


def instantiate_loggers(logger_cfg: Any) -> list:
    return _instantiate_group(logger_cfg, "logger")


def log_hyperparameters(object_dict: dict) -> None:
    """Push the composed config and the policy's parameter count to every
    logger."""
    cfg = object_dict.get("cfg", {})
    trainer = object_dict.get("trainer")
    model = object_dict.get("model")
    if trainer is None or not getattr(trainer, "logger", None):
        return
    hparams = {k: config_engine.to_container(v) if isinstance(v, dict) else v
               for k, v in dict.items(cfg)}
    if model is not None:
        hparams["model/params/total"] = sum(p.numel() for p in model.policy.parameters())
    trainer.logger.log_hyperparams(hparams)
