"""RLBench ACT closed-loop evaluation, the port's entry point (the
counterpart of ``src/test_rlbench_act.py``; the reference's
`src/test_rlbench_act.py:98-245`).

Composes ``configs/test_rlbench_act.yaml``, restores the port checkpoint
``ckpt_path`` (a reference-trained Lightning checkpoint converts through
``python -m pointcloudmatters_tpu_torch.port_reference_ckpt``), launches
CoppeliaSim through ``rlbench_utils.build_env_and_task``, replays the stored
demos' variations (``rlbench_utils.reset_task``), encodes each task
description as the goal (CLIP, else ``clip_cache_path``'s embeddings, else a
hash), and rolls the policy closed-loop from the card (the trainer's
``accelerator``) with temporal aggregation and the IK retry budget. The
success rate is appended to ``result_path/result_file``::

    python -m pointcloudmatters_tpu_torch.test_rlbench_act exp_rlbench_act_policy=base \\
        exp_rlbench_act_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd \\
        rlbench_task=close_jar ckpt_path=...

The simulator needs ``rlbench``, PyRep and CoppeliaSim on the host.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from pointcloudmatters_tpu_torch.envs.rlbench_eval import run_rlbench_act_eval
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import config as C
from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger
from pointcloudmatters_tpu_torch.utils.utils import seed_everything, task_wrapper

__all__ = ["build_model_and_state", "make_convert_obs", "write_result", "evaluate", "main"]

log = RankedLogger(__name__, rank_zero_only=True)


def build_model_and_state(cfg):
    """(module, trainer, datamodule): the task module with its policy on the
    trainer's device, set up over the training set as ``fit`` sets it up
    (the Diffusion Policy's normalizer wired), and the checkpoint
    ``ckpt_path`` restored."""
    from pointcloudmatters_tpu_torch.train import instantiate_model

    datamodule = C.instantiate(cfg.data)
    model = instantiate_model(cfg)
    # the configured accumulation, which a training checkpoint's state matches
    trainer = Trainer(default_root_dir=C.select(cfg, "paths.output_dir") or ".",
                      accelerator=C.select(cfg, "trainer.accelerator") or "auto", devices=1,
                      accumulate_grad_batches=C.select(cfg, "trainer.accumulate_grad_batches")
                      or 1)
    if hasattr(datamodule, "setup"):
        datamodule.setup("fit")
    trainer._start(model, datamodule, datamodule.train_dataloader(), trainer.select_device())
    if cfg.get("ckpt_path"):
        trainer.restore_checkpoint(cfg.ckpt_path)
    return model, trainer, datamodule


def make_convert_obs(cfg, datamodule):
    """An RLBench observation -> a batch of one policy input, through the
    training set's pipeline (`test_rlbench_act.py:71-94`)."""
    train_ds = datamodule.data_train
    is_pcd = "pcd" in type(train_ds).__name__.lower()
    collision = bool(C.select(cfg, "data.train.collision"))
    task_name = cfg.rlbench_task
    pad_multiple = getattr(datamodule, "pad_multiple", 512)

    def convert(obs):
        data = {"qpos": RU.get_qpos_data([obs], task_name, collision)[0][None]}
        if is_pcd:
            data["pcds"] = RU.get_pcd([obs], train_ds.cameras, train_ds.transform_pcd,
                                      use_mask=getattr(train_ds, "use_mask", False),
                                      pad_multiple=pad_multiple)
        else:
            data["image"] = RU.get_image_data(obs, train_ds.cameras,
                                              train_ds.include_depth)[None]
        return data

    return convert


def write_result(cfg, success_rate: float) -> str:
    """Append ``<result_name>: <rate>`` to ``result_path/result_file``; the
    file's path."""
    os.makedirs(cfg.result_path, exist_ok=True)
    full_path = os.path.join(cfg.result_path, cfg.result_file)
    with open(full_path, "a") as f:
        f.write(f"{cfg.result_name}: {success_rate}\n")
    log.info(f"Results saved to {full_path}")
    return full_path


def reset_fn_of(task, cfg):
    def reset_fn(ep):
        _, _, description, obs = RU.reset_task(task, cfg, ep)
        log.info(f"Episode {ep + 1}/{cfg.episodes_num}: {description[0]}")
        return description[0], obs

    return reset_fn


@task_wrapper
def evaluate(cfg) -> tuple[dict, dict]:
    if cfg.get("seed"):
        seed_everything(cfg.seed)
    env, task = RU.build_env_and_task(cfg)
    log.info(f"Testing RLBench {cfg.rlbench_task} task...")
    text_encoder = RU.build_text_encoder(cache_path=cfg.get("clip_cache_path"))
    model, trainer, datamodule = build_model_and_state(cfg)
    convert_obs = make_convert_obs(cfg, datamodule)

    def predict(obs, description):
        data = convert_obs(obs)
        data["goal_cond"] = text_encoder.encode(description).reshape(1, -1)
        return model.predict(data)[0].float().cpu().numpy()

    success_rate = run_rlbench_act_eval(
        predict=predict, reset_fn=reset_fn_of(task, cfg), step_fn=task.step,
        task_name=cfg.rlbench_task, episodes_num=cfg.episodes_num, max_steps=cfg.max_steps,
        collision=bool(C.select(cfg, "data.train.collision")),
        temporal_agg=bool(C.select(cfg, "temporal_agg.apply")),
        # the ensembling runs in 6D-rotation space: data.train.action_dim wide
        agg_action_dim=int(C.select(cfg, "temporal_agg.action_dim") or 11),
        agg_chunk_size=int(C.select(cfg, "temporal_agg.chunk_size") or 16),
        agg_k=float(C.select(cfg, "temporal_agg.k") or 0.01),
    )
    log.info(f"success_rate: {success_rate}")
    write_result(cfg, success_rate)
    env.shutdown()
    return {"success_rate": success_rate}, {"cfg": cfg, "model": model, "trainer": trainer}


def run(config_name: str, task, argv: Optional[list[str]]) -> dict:
    """Compose ``configs/<config_name>.yaml`` with ``argv`` and run ``task``;
    its metric dict."""
    from pointcloudmatters_tpu_torch.train import compose_run

    argv = list(sys.argv[1:] if argv is None else argv)
    metric_dict, _ = task(compose_run(argv, config_name=config_name))
    return metric_dict


def main(argv: Optional[list[str]] = None) -> dict:
    return run("test_rlbench_act", evaluate, argv)


if __name__ == "__main__":
    main()
