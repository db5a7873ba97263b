"""Training entry point of the port (the counterpart of ``src/train.py``).

Composes the repository's ``configs/`` tree with the port's composer, whose
``_target_`` nodes build the port's classes, and trains on the card unless
the composed trainer says ``accelerator: cpu`` (``trainer=cpu``,
``debug=default``)::

    python -m pointcloudmatters_tpu_torch.train exp_maniskill2_act_policy=base \\
        exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd \\
        exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0 \\
        data.train.dataset_file=...

Checkpoints go to ``<run dir>/checkpoints`` (``last`` and the top-k);
``ckpt_path=<checkpoint>`` resumes from one. ``-m`` runs a sweep's jobs one
after the other under ``hydra.sweep.dir/<job>``, and ``optimized_metric``
names the value ``main`` returns.

The policy's weights are drawn from ``seed`` (``entry.init_parameters``),
the draws the JAX package makes from ``model.seed`` in distribution; a
configured ``pretrained_path`` (SpUNet's PonderV2 file) is copied in next,
and a restored checkpoint then replaces them.

Across devices (``trainer=ddp``, the shipped default: ``devices: auto``),
one process a device, as Lightning's DDP runs the reference: a composed
trainer asking for W > 1 processes (an int ``devices`` > 1, ``auto`` on a
machine with several cards, ``accelerator: cpu`` with ``devices`` > 1)
makes this process rank 0 and starts W - 1 more, each running the same
command with torchrun's variables and the run directory set; under torchrun
or SLURM each process joins the group their variables describe.
``devices`` above the machine's cards raises before any process starts, as
``num_nodes`` > 1 does without torchrun's or SLURM's variables. Every rank
returns the optimized metric.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from pointcloudmatters_tpu_torch.entry import init_parameters
from pointcloudmatters_tpu_torch.models.components.pretrained import load_pretrained_into
from pointcloudmatters_tpu_torch.utils import config as C
from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger
from pointcloudmatters_tpu_torch.utils.utils import (
    extras,
    get_metric_value,
    instantiate_callbacks,
    instantiate_loggers,
    log_hyperparameters,
    seed_everything,
    task_wrapper,
)

__all__ = ["CONFIG_DIR", "instantiate_model", "train", "run_ranks", "main"]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")

log = RankedLogger(__name__, rank_zero_only=True)


def instantiate_model(cfg):
    """The task module of ``cfg.model``, its ``seed`` set to the run's, its
    policy's weights drawn from that seed and then any configured
    ``pretrained_path`` checkpoint copied in (``load_pretrained_into``)."""
    model = C.instantiate(cfg.model)
    model.seed = cfg.get("seed") or 0
    init_parameters(model.policy, torch.Generator().manual_seed(model.seed))
    load_pretrained_into(model.policy)
    return model


@task_wrapper
def train(cfg) -> tuple[dict, dict]:
    """Fit the composed model (``src/train.py``'s ``train``): the metric dict
    and the objects built."""
    if cfg.get("seed") is not None:
        seed_everything(cfg.seed)

    log.info("Instantiating datamodule...")
    datamodule = C.instantiate(cfg.data)

    log.info("Instantiating model...")
    model = instantiate_model(cfg)

    callbacks = instantiate_callbacks(cfg.get("callbacks"))
    loggers = instantiate_loggers(cfg.get("logger"))

    log.info("Instantiating trainer...")
    trainer = C.instantiate(cfg.trainer, callbacks=callbacks, logger=loggers)

    object_dict = {
        "cfg": cfg, "datamodule": datamodule, "model": model,
        "callbacks": callbacks, "logger": loggers, "trainer": trainer,
    }

    metric_dict: dict = {}
    if cfg.get("train", True):
        log.info("Starting training!")
        trainer.fit(model, datamodule=datamodule, ckpt_path=cfg.get("ckpt_path"))
        log_hyperparameters(object_dict)
        metric_dict.update(model.train_metrics.compute())
        metric_dict.update(model.best_val_metrics.compute())

    if cfg.get("test"):
        log.info("Starting testing!")
        ckpt = None
        if trainer.checkpoint_callback is not None:
            ckpt = trainer.checkpoint_callback.best_model_path or None
        if ckpt is None:
            log.warning("Best ckpt not found! Using current weights for testing...")
        metric_dict.update(trainer.validate(model, datamodule=datamodule, ckpt_path=ckpt))

    return {k: float(v) for k, v in metric_dict.items()}, object_dict


def _resolve_dir_template(cfg, template: str) -> str:
    # the templated run directory, resolved against a copy (paths.output_dir
    # itself refers to the value being computed here)
    probe = C.DotDict(C.to_container(cfg))
    return os.path.abspath(str(C._Resolver(probe).resolve_str(str(template))))


def compose_run(argv: list[str], output_dir: Optional[str] = None, config_name: str = "train"):
    """The resolved config of one run of ``argv`` over ``configs/<config_name>.yaml``,
    its output directory made (``hydra.run.dir`` unless ``output_dir`` is
    given)."""
    cfg = C.compose(CONFIG_DIR, config_name, argv)
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    if output_dir is None:
        run_dir_tpl = C.select(cfg.get("hydra") or {}, "run.dir") or "outputs"
        output_dir = _resolve_dir_template(cfg, run_dir_tpl)
    os.makedirs(output_dir, exist_ok=True)
    C.set_runtime(output_dir=output_dir, cwd=os.getcwd())
    C.resolve_config(cfg)
    extras(cfg)
    return cfg


def run_ranks(task: Callable, cfg, argv: list[str], module: str):
    """``task(cfg)`` in the process group ``cfg.trainer`` asks for (module
    doc): started here, with ranks 1 .. W - 1 running ``python -m module
    argv`` in the run directory, or joined from torchrun's or SLURM's
    variables; ``task``'s result. The group ends with the task."""
    trainer = cfg.trainer
    accelerator = trainer.get("accelerator", "auto")
    world = dist.requested_world(accelerator, trainer.get("devices", "auto"),
                                 int(trainer.get("num_nodes") or 1))
    env, procs = None, []
    if world > 1 and not dist.is_initialized() and dist.process_env() is None:
        argv = [*argv, f"hydra.run.dir={C.select(cfg, 'paths.output_dir')}"]
        log.info(f"starting ranks 1-{world - 1} of {world}: python -m {module}")
        env, procs = dist.spawn_ranks(module, argv, world)
    joined = not dist.is_initialized()
    try:
        dist.init_dist("cpu" if accelerator == "cpu" else "cuda", env)
        result = task(cfg)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        if joined:
            dist.destroy()
        codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks 1-{len(procs)} exited with {codes}")
    return result


def _run_one(argv: list[str], output_dir: Optional[str] = None) -> Optional[float]:
    cfg = compose_run(argv, output_dir)
    metric_dict, _ = run_ranks(train, cfg, argv, "pointcloudmatters_tpu_torch.train")
    return get_metric_value(metric_dict, cfg.get("optimized_metric"))


def main(argv: Optional[list[str]] = None) -> Optional[float]:
    """Run ``argv`` (``sys.argv[1:]`` by default); the optimized metric of
    the run, or of a sweep's last job."""
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        while flag in argv:
            argv.remove(flag)
            multirun = True
    if not multirun:
        return _run_one(argv)

    # -m: the comma sweeps' product of jobs, run in turn under
    # hydra.sweep.dir/<job index>
    jobs = C.expand_multirun(argv)
    cfg0 = C.compose(CONFIG_DIR, "train", jobs[0])
    C.set_runtime(cwd=os.getcwd(), output_dir="<pending>")
    sweep_tpl = C.select(cfg0.get("hydra") or {}, "sweep.dir") or "multirun"
    sweep_dir = _resolve_dir_template(cfg0, sweep_tpl)
    log.info(f"multirun: {len(jobs)} job(s) under {sweep_dir}")
    result: Optional[float] = None
    for i, job in enumerate(jobs):
        log.info(f"multirun job {i}/{len(jobs)}: {' '.join(job)}")
        result = _run_one(job, output_dir=os.path.join(sweep_dir, str(i)))
    return result


if __name__ == "__main__":
    main()
