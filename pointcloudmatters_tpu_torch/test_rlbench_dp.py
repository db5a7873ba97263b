"""RLBench Diffusion Policy closed-loop evaluation, the port's entry point
(the counterpart of ``src/test_rlbench_dp.py``): as ``test_rlbench_act``,
with an ``n_obs_steps`` observation history and every predicted action
executed before the next prediction; the chains draw from one generator
seeded with ``seed``::

    python -m pointcloudmatters_tpu_torch.test_rlbench_dp exp_rlbench_diffusion_policy=base \\
        exp_rlbench_diffusion_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd \\
        rlbench_task=close_jar ckpt_path=...
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointcloudmatters_tpu_torch.envs.rlbench_eval import run_rlbench_dp_eval
from pointcloudmatters_tpu_torch.test_rlbench_act import (
    build_model_and_state,
    reset_fn_of,
    run,
    write_result,
)
from pointcloudmatters_tpu_torch.utils import config as C
from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger
from pointcloudmatters_tpu_torch.utils.utils import seed_everything, task_wrapper

__all__ = ["evaluate", "main"]

log = RankedLogger(__name__, rank_zero_only=True)


@task_wrapper
def evaluate(cfg) -> tuple[dict, dict]:
    if cfg.get("seed"):
        seed_everything(cfg.seed)
    env, task = RU.build_env_and_task(cfg)
    log.info(f"Testing RLBench {cfg.rlbench_task} task (diffusion policy)...")
    text_encoder = RU.build_text_encoder(cache_path=cfg.get("clip_cache_path"))
    model, trainer, datamodule = build_model_and_state(cfg)
    train_ds = datamodule.data_train
    is_pcd = "pcd" in type(train_ds).__name__.lower()
    collision = bool(C.select(cfg, "data.train.collision"))
    n_obs_steps = int(model.policy.n_obs_steps)
    pad_multiple = getattr(datamodule, "pad_multiple", 512)
    generator = torch.Generator(device=model.device).manual_seed(cfg.get("seed") or 0)

    def predict(hist_obs, description):
        obs_dict = {"qpos": RU.get_qpos_data(hist_obs, cfg.rlbench_task, collision)[None]}
        if is_pcd:
            obs_dict["pcds"] = RU.get_pcd(
                hist_obs, train_ds.cameras, train_ds.transform_pcd,
                use_mask=getattr(train_ds, "use_mask", False), n_obs_steps=n_obs_steps,
                pad_multiple=pad_multiple)
        else:
            obs_dict["front_rgb"] = np.stack([
                RU.get_image_data(o, train_ds.cameras, False)[0] for o in hist_obs])[None]
        data = {"obs": obs_dict,
                "goal": {"task_emb": text_encoder.encode(description).reshape(1, -1)}}
        return model.predict(data, generator)[0].float().cpu().numpy()

    success_rate = run_rlbench_dp_eval(
        predict=predict, reset_fn=reset_fn_of(task, cfg), step_fn=task.step,
        task_name=cfg.rlbench_task, n_obs_steps=n_obs_steps,
        episodes_num=cfg.episodes_num, max_steps=cfg.max_steps, collision=collision)
    log.info(f"success_rate: {success_rate}")
    write_result(cfg, success_rate)
    env.shutdown()
    return {"success_rate": success_rate}, {"cfg": cfg, "model": model, "trainer": trainer}


def main(argv: Optional[list[str]] = None) -> dict:
    return run("test_rlbench_dp", evaluate, argv)


if __name__ == "__main__":
    main()
