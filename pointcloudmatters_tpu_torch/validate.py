"""Validation entry point of the port (the counterpart of
``src/validate.py``): composes ``configs/`` as ``train`` does, restores the
checkpoint ``ckpt_path=...`` (required) and validates it::

    python -m pointcloudmatters_tpu_torch.validate <train's overrides> ckpt_path=<checkpoint>

``main`` returns the validation's metrics. Across devices it runs as
``train`` does (``train.run_ranks``).
"""

from __future__ import annotations

import sys
from typing import Optional

from pointcloudmatters_tpu_torch.train import compose_run, instantiate_model, run_ranks
from pointcloudmatters_tpu_torch.utils import config as C
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger
from pointcloudmatters_tpu_torch.utils.utils import instantiate_loggers, seed_everything, task_wrapper

__all__ = ["validate", "main"]

log = RankedLogger(__name__, rank_zero_only=True)


@task_wrapper
def validate(cfg) -> tuple[dict, dict]:
    if not cfg.get("ckpt_path"):
        raise ValueError("validate requires ckpt_path=...")
    if cfg.get("seed") is not None:
        seed_everything(cfg.seed)

    log.info("Instantiating datamodule...")
    datamodule = C.instantiate(cfg.data)
    log.info("Instantiating model...")
    model = instantiate_model(cfg)
    loggers = instantiate_loggers(cfg.get("logger"))
    log.info("Instantiating trainer...")
    trainer = C.instantiate(cfg.trainer, callbacks=[], logger=loggers)

    object_dict = {"cfg": cfg, "datamodule": datamodule, "model": model,
                   "logger": loggers, "trainer": trainer}
    log.info("Starting validation!")
    metric_dict = trainer.validate(model, datamodule=datamodule, ckpt_path=cfg.ckpt_path)
    log.info(f"Validation metrics: {metric_dict}")
    return metric_dict, object_dict


def main(argv: Optional[list[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    metric_dict, _ = run_ranks(validate, compose_run(argv), argv,
                               "pointcloudmatters_tpu_torch.validate")
    return metric_dict


if __name__ == "__main__":
    main()
