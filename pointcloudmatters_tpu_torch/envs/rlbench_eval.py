"""Closed-loop RLBench evaluation loops (port of
``pointcloudmatters_tpu/envs/rlbench_eval.py``).

The protocol of the reference's `src/test_rlbench_act.py:98-242` and
`src/test_rlbench_dp.py`: replayed-variation episodes (25), at most 200
steps, the CLIP-encoded task description as the goal, ACT's chunks
ensembled in 6D-rotation space, positions un-normalized by the task's
loc-bounds, gripper and collision thresholded at 0.5, and an IK-error retry
budget (20 tries at step 0, 1 after).

The simulator comes in as ``reset_fn`` / ``step_fn`` with the RLBench
contract (``step(action) -> (obs, reward, terminate)``), so the loops run
against a fake task in tests. The rotation conversions of the ensembling
run in f32 on the host, as JAX's do (there the float64 buffer becomes f32
on its way into the device arrays).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pointcloudmatters_tpu_torch.utils.misc import TemporalAgg
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger
from pointcloudmatters_tpu_torch.utils.rlbench_utils import unnormalize_position
from pointcloudmatters_tpu_torch.utils.rotation_conversions import (
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)

__all__ = ["run_rlbench_act_eval", "run_rlbench_dp_eval"]

log = RankedLogger(__name__, rank_zero_only=True)


def _sim_errors() -> tuple:
    errors: list = []
    try:
        from pyrep.errors import ConfigurationPathError, IKError

        errors += [ConfigurationPathError, IKError]
    except ImportError:
        pass
    try:
        from rlbench.backend.exceptions import InvalidActionError

        errors.append(InvalidActionError)
    except ImportError:
        pass
    return tuple(errors) or (RuntimeError,)


def _threshold_gripper(action: np.ndarray, collision: bool) -> np.ndarray:
    action = action.copy()
    if collision:
        action[..., -1] = (action[..., -1] > 0.5).astype(float)
        action[..., -2] = (action[..., -2] > 0.5).astype(float)
    else:
        action[..., -1] = (action[..., -1] > 0.5).astype(float)
    return action


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _agg_in_6d(pred_action: np.ndarray, agg: TemporalAgg) -> np.ndarray:
    """Ensemble chunks in 6D-rotation space, then back to a quaternion
    (`test_rlbench_act.py:170-189`). pred_action: (chunk, 3+4+rest)."""
    rot6d = matrix_to_rotation_6d(quaternion_to_matrix(_f32(pred_action[:, 3:7]))).numpy()
    in_6d = np.concatenate([pred_action[:, :3], rot6d, pred_action[:, 7:]], -1)
    out = agg(in_6d)  # (3+6+rest,)
    quat_out = matrix_to_quaternion(rotation_6d_to_matrix(_f32(out[None, 3:9]))).numpy()[0]
    return np.concatenate([out[:3], quat_out, out[9:]], -1)


def run_rlbench_act_eval(
    predict: Callable[[dict, str], np.ndarray],
    reset_fn: Callable[[int], tuple],
    step_fn: Callable[[np.ndarray], tuple],
    task_name: str,
    episodes_num: int = 25,
    max_steps: int = 200,
    collision: bool = True,
    temporal_agg: bool = True,
    agg_action_dim: int = 10,
    agg_chunk_size: int = 16,
    agg_k: float = 0.01,
    on_episode_end: Optional[Callable] = None,
) -> float:
    """Returns the success rate over ``episodes_num`` episodes.

    predict(obs, description) -> (chunk, 3+4+1(+1)) action chunk with
    quaternion rotation (the RLBench heads emit quats at eval).
    """
    errors = _sim_errors()
    success_count = 0
    for ep in range(episodes_num):
        description, obs = reset_fn(ep)
        agg = TemporalAgg(apply=temporal_agg, action_dim=agg_action_dim,
                          chunk_size=agg_chunk_size, k=agg_k)
        reward = 0.0
        for step_id in range(max_steps):
            pred_action = np.asarray(predict(obs, description))  # (chunk, D)
            if step_id != 0 and temporal_agg:
                pred_action = _agg_in_6d(pred_action, agg)[None]
            elif temporal_agg:
                # warm the buffer with the first chunk in 6D space
                _agg_in_6d(pred_action, agg)
            pred_action = unnormalize_position(pred_action, task_name)
            pred_action = _threshold_gripper(pred_action, collision)

            max_retry = 20 if step_id == 0 else 1
            terminate = False
            for i in range(max_retry):
                try:
                    obs, reward, terminate = step_fn(pred_action[min(i, len(pred_action) - 1)])
                    if reward == 1:
                        success_count += 1
                    break
                except errors as e:  # IK/planning failures: retry next row
                    log.info(f"sim step error (retry {i}): {e}")
                    reward = 0.0
            if reward == 1 or terminate:
                break
        if on_episode_end is not None:
            on_episode_end(ep, reward == 1)
        log.info(f"episode {ep + 1}/{episodes_num}: success={reward == 1}")
    return success_count / float(episodes_num)


def run_rlbench_dp_eval(
    predict: Callable[[list, str], np.ndarray],
    reset_fn: Callable[[int], tuple],
    step_fn: Callable[[np.ndarray], tuple],
    task_name: str,
    n_obs_steps: int = 2,
    episodes_num: int = 25,
    max_steps: int = 200,
    collision: bool = True,
    on_episode_end: Optional[Callable] = None,
) -> float:
    """DP protocol: obs history window, execute every predicted action
    (`src/test_rlbench_dp.py`). predict(hist_obs, description) ->
    (n_action_steps, 3+4+rest)."""
    errors = _sim_errors()
    success_count = 0
    for ep in range(episodes_num):
        description, obs = reset_fn(ep)
        hist = [obs] * n_obs_steps
        reward = 0.0
        steps = 0
        done = False
        while not done and steps < max_steps:
            actions = np.asarray(predict(hist, description))
            if actions.ndim == 1:
                actions = actions[None]
            actions = unnormalize_position(actions, task_name)
            actions = _threshold_gripper(actions, collision)
            for a_idx in range(len(actions)):
                max_retry = 20 if steps == 0 else 1
                terminate = False
                for i in range(max_retry):
                    try:
                        obs, reward, terminate = step_fn(actions[a_idx])
                        break
                    except errors as e:
                        log.info(f"sim step error (retry {i}): {e}")
                        reward = 0.0
                hist = hist[1:] + [obs]
                steps += 1
                if reward == 1:
                    success_count += 1
                    done = True
                    break
                if terminate or steps >= max_steps:
                    done = True
                    break
        if on_episode_end is not None:
            on_episode_end(ep, reward == 1)
        log.info(f"episode {ep + 1}/{episodes_num}: success={reward == 1}")
    return success_count / float(episodes_num)
