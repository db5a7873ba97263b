"""Preprocess raw RLBench demos into training ``.npy`` episodes, the port's
entry point (the counterpart of ``scripts/preprocess_rlbench.py``, line for
line; it imports nothing of JAX).

Replays each stored demo through CoppeliaSim, flattens each frame into a
dict of camera modalities and low-dim and gripper states, encodes the task
description as the goal, and writes ``{"demo": [...], "task_goal": (512,)}``
to ``<save_root>/<stage>/<task>/ep<i>.npy``: the first 100 episodes of
``train`` and 25 of ``val`` (:data:`EPISODES`), which the port's
``RLBenchSingleTask*Dataset``s read. The text embeddings also go into
``<save_root>/clip_cache.npz`` (``utils/rlbench_utils.CachedTextEncoder``),
so the closed-loop evaluation needs no CLIP weights; ``--text-encoder hash``
runs offline (smoke tests)::

    python -m pointcloudmatters_tpu_torch.preprocess_rlbench --task_names close_jar,open_drawer

``--headless`` is a flag whose default is already true, so the simulator
always runs headless, as in the reference. ``rlbench`` (with PyRep and
CoppeliaSim) is imported inside :func:`main` only.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Optional

import numpy as np

from pointcloudmatters_tpu_torch.utils.rlbench_utils import (
    CachedTextEncoder,
    HashTextEncoder,
    build_text_encoder,
    task_file_to_task_class,
)

__all__ = ["EPISODES", "main"]

EPISODES = {"train": 100, "val": 25}  # episodes a stage, as the reference replays them


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--task_names", type=str, default="turn_tap")
    parser.add_argument("--camera_views", type=str, default="front")
    parser.add_argument(
        "--modalities", type=str, default="rgb,depth,mask,point_cloud"
    )
    parser.add_argument(
        "--low_dim_states", type=str,
        default="joint_velocities,joint_positions,joint_forces,task_low_dim_state",
    )
    parser.add_argument(
        "--gripper_states", type=str,
        default="gripper_open,gripper_pose,gripper_matrix,"
                "gripper_joint_positions,gripper_touch_forces",
    )
    parser.add_argument("--root", default="data/rlbench/raw")
    parser.add_argument("--save_root", default="data/rlbench/processed")
    parser.add_argument("--headless", action="store_true", default=True)
    parser.add_argument("--text-encoder", choices=["clip", "hash", "auto"],
                        default="auto")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from rlbench.action_modes.action_mode import MoveArmThenGripper
    from rlbench.action_modes.arm_action_modes import EndEffectorPoseViaPlanning
    from rlbench.action_modes.gripper_action_modes import Discrete
    from rlbench.environment import Environment
    from rlbench.observation_config import ObservationConfig

    if args.text_encoder == "hash":
        encoder = HashTextEncoder()
    else:
        encoder = build_text_encoder()
    cache = CachedTextEncoder(os.path.join(args.save_root, "clip_cache.npz"))

    for stage in ["train", "val"]:
        dataset_dir = os.path.join(args.root, stage)
        episodes_num = EPISODES[stage]
        for task_name in args.task_names.split(","):
            print(f"Processing {stage} data of task {task_name}...")
            env = Environment(
                action_mode=MoveArmThenGripper(
                    arm_action_mode=EndEffectorPoseViaPlanning(
                        collision_checking=False
                    ),
                    gripper_action_mode=Discrete(),
                ),
                dataset_root=dataset_dir,
                obs_config=ObservationConfig(),
                headless=args.headless,
            )
            env.launch()
            task = env.get_task(task_file_to_task_class(task_name))

            for ep in range(episodes_num):
                ep_dir = os.path.join(
                    dataset_dir, task_name, "all_variations", "episodes",
                    f"episode{ep}",
                )
                with open(os.path.join(ep_dir, "variation_number.pkl"), "rb") as f:
                    var_num = pickle.load(f)
                task.set_variation(-1)
                demos = task.get_demos(
                    1, random_selection=False, live_demos=False,
                    from_episode_number=ep,
                )
                task.set_variation(var_num)
                description, obs = task.reset_to_demo(demos[0])
                with open(
                    os.path.join(ep_dir, "variation_descriptions.pkl"), "rb"
                ) as f:
                    gt_description = pickle.load(f)
                assert gt_description[0] == description[0], (
                    gt_description[0], description[0]
                )
                task_goal = encoder.encode(description[0])
                cache.put(description[0], task_goal)

                demo_array = []
                for frame in np.array(demos[0]).flatten():
                    frame_dict = {
                        "ignore_collisions": frame.ignore_collisions,
                    }
                    for view in args.camera_views.split(","):
                        for modality in args.modalities.split(","):
                            frame_dict[f"{view}_{modality}"] = getattr(
                                frame, f"{view}_{modality}"
                            )
                    for state in (args.low_dim_states.split(",")
                                  + args.gripper_states.split(",")):
                        frame_dict[state] = getattr(frame, state)
                    demo_array.append(frame_dict)

                out_dir = os.path.join(args.save_root, stage, task_name)
                os.makedirs(out_dir, exist_ok=True)
                np.save(
                    os.path.join(out_dir, f"ep{ep}.npy"),
                    dict(demo=demo_array, task_goal=task_goal),
                    allow_pickle=True,
                )
                print(f"  episode {ep + 1}/{episodes_num}")
            env.shutdown()
    cache.save()
    print(f"Wrote text-embedding cache to {cache.cache_path}")


if __name__ == "__main__":
    main()
