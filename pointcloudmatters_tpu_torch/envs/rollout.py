"""Closed-loop ManiSkill2 rollouts (port of
``pointcloudmatters_tpu/envs/rollout.py``): the validation protocol of the
reference (`src/models/maniskill2_act_bc_module.py:120-323`).

Episodes are seeded ``10240 + idx`` (TurnFaucet: 10 held-out faucet models x
40 episodes); PegInsertionSide reports grasp and align beside success; each
step's observation goes through the training dataset's point-cloud pipeline
in test mode (``build_act_obs``, ``build_dp_obs``, padded as the collate
pads); ACT's chunks are ensembled by ``TemporalAgg`` and its actions
un-z-scored. The simulator is a host process; ``predict`` serves the policy
from the card. The env is anything with gymnasium's 5-tuple ``step``, so a
fake env drives the loop where there is no simulator.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from pointcloudmatters_tpu_torch.data.collate import pad_point_clouds
from pointcloudmatters_tpu_torch.utils.misc import TemporalAgg
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["TURN_FAUCET_MODELS", "build_act_obs", "build_dp_obs", "run_maniskill2_rollouts",
           "run_maniskill2_dp_rollouts", "maniskill2_env_kwargs", "make_maniskill2_env"]

log = RankedLogger(__name__, rank_zero_only=True)

TURN_FAUCET_MODELS = [
    "5002", "5021", "5023", "5028", "5029",
    "5045", "5047", "5051", "5056", "5063",
]


def build_act_obs(obs: dict, dataset, pad_multiple: int = 512) -> dict:
    """Build a batch-of-1 policy input from a raw env observation, reusing the
    train dataset's normalization stats and pcd transforms in test mode
    (`maniskill2_act_bc_module.py:164-271`)."""
    qpos = np.asarray(obs["agent"]["qpos"], np.float32)
    qpos = (qpos - dataset.norm_stats["qpos_mean"]) / dataset.norm_stats["qpos_std"]
    data = {"qpos": qpos[None].astype(np.float32)}

    goal = dataset.get_goal(obs) if dataset.goal_cond_keys else None
    if goal is not None:
        data["goal_cond"] = np.asarray(goal, np.float32).reshape(1, -1)

    if "image" in obs:
        images = []
        for cam in getattr(dataset, "camera_names", list(obs["image"])):
            img = np.asarray(obs["image"][cam]["rgb"], np.float32) / 255.0
            if getattr(dataset, "include_depth", False):
                depth = np.asarray(obs["image"][cam]["depth"], np.float32)
                img = np.concatenate([img, depth], axis=-1)
            images.append(img)
        data["image"] = np.stack(images)[None]  # (1, ncam, H, W, C) NHWC
    elif "pointcloud" in obs:
        side = int(round(dataset.point_num_per_cam ** 0.5))
        coords = np.asarray(obs["pointcloud"]["xyzw"], np.float32).reshape(
            -1, side, side, 4
        )[dataset.camera_ids].copy()
        if getattr(dataset, "pointmap", False):
            colors = np.asarray(obs["pointcloud"]["rgb"], np.float32).reshape(
                -1, side, side, 3
            )[dataset.camera_ids] / 255.0
            colors[coords[..., -1] == 0] = 0
            coords[coords[..., -1] == 0] = 0
            image = np.concatenate([colors, coords[..., :3]], axis=-1)
            data["image"] = image[None].astype(np.float32)
        else:
            if getattr(dataset, "rand_crop", False):
                crop = int(side * 112 / 128)
                s = (side - crop) // 2  # center crop at eval
                coords[:, :s] = 0
                coords[:, s + crop:] = 0
                coords[:, :, :s] = 0
                coords[:, :, s + crop:] = 0
            coords = coords.reshape(-1, 4)
            colors = np.asarray(obs["pointcloud"]["rgb"], np.float32).reshape(
                -1, dataset.point_num_per_cam, 3
            )[dataset.camera_ids].reshape(-1, 3)
            keep = coords[..., -1] > 0
            colors, coords = colors[keep], coords[keep][:, :3]
            if not getattr(dataset, "include_ground", False):
                keep = coords[..., -1] > 0.005
            else:
                keep = coords[..., 0] > -0.8
            colors, coords = colors[keep], coords[keep]
            pcd = dataset.transform_pcd(
                dict(coord=coords.astype(np.float32),
                     color=colors.astype(np.float32)),
                mode="test",
            )
            if getattr(dataset, "include_ground", False):
                pcd["mask"] = pcd["coord"][:, -1] > 0.005
            data["pcds"] = pad_point_clouds([pcd], pad_multiple=pad_multiple)
    return data


def _episode_options(env_id: str, idx: int) -> dict:
    if env_id == "TurnFaucet-v0":
        return {"model_id": TURN_FAUCET_MODELS[idx // 40]}
    return {}


def _drive_episodes(
    episode_fn: Callable,
    env,
    env_factory: Optional[Callable],
    n_episodes: int,
    num_envs: int,
    staged: bool,
    on_episode_end: Optional[Callable],
) -> dict:
    """Run ``episode_fn(env, idx) -> (success, grasp, align, rewards)`` for
    every episode, serially or overlapped.

    Pooled (``num_envs > 1`` with an ``env_factory``): simulators are
    host-bound, so W worker threads each own an env and run whole episodes
    concurrently; the caller's ``predict`` serializes the policy (a lock
    around the card's forward), so the card serves one env while the others
    step on the host. Episode seeds and protocol follow the index, so the
    results equal the serial order's.
    """
    results: list = [None] * n_episodes
    if num_envs <= 1 or env_factory is None:
        for idx in range(n_episodes):
            results[idx] = episode_fn(env, idx)
            if on_episode_end is not None:
                success, _, _, rewards = results[idx]
                on_episode_end(idx, success, rewards)
    else:
        import queue as _queue
        import threading

        todo: _queue.Queue = _queue.Queue()
        for idx in range(n_episodes):
            todo.put(idx)
        errors: list = []

        def worker():
            w_env = None
            try:
                w_env = env_factory()
                while True:
                    try:
                        idx = todo.get_nowait()
                    except _queue.Empty:
                        return
                    results[idx] = episode_fn(w_env, idx)
            except Exception as e:  # noqa: BLE001
                # env construction failures land here too — a dead worker
                # must surface, not silently shrink the episode set
                errors.append(e)
            finally:
                close = getattr(w_env, "close", None)
                if close is not None:
                    close()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(num_envs)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if on_episode_end is not None:
            for idx, r in enumerate(results):
                if r is not None:
                    on_episode_end(idx, r[0], r[3])

    done = [r for r in results if r is not None]
    successes = [r[0] for r in done]
    metrics = {"mean_success": float(np.mean(successes)) if successes else 0.0}
    if staged and done:
        metrics["mean_grasp"] = float(np.mean([r[1] for r in done]))
        metrics["mean_align"] = float(np.mean([r[2] for r in done]))
    return metrics


def run_maniskill2_rollouts(
    predict: Callable[[dict], np.ndarray],
    dataset,
    env,
    env_id: str,
    n_episodes: int,
    action_dim: int,
    num_queries: int,
    temporal_agg: bool = True,
    max_steps: int = 500,
    pad_multiple: int = 512,
    seed_base: int = 10240,
    on_episode_end: Optional[Callable] = None,
    env_factory: Optional[Callable] = None,
    num_envs: int = 1,
) -> dict:
    """Run the validation protocol; returns metric dict with ``mean_success``
    (+ grasp/align for the staged PegInsertion variant).

    ``num_envs > 1`` (with ``env_factory``) overlaps host simulation across a
    pool of envs while the device serves predictions — wall-clock per epoch
    approaches max(sim, policy) instead of their sum.
    """
    staged = "3steps" in env_id or env_id == "PegInsertionSide-v0"

    def episode(ep_env, idx):
        obs, _ = ep_env.reset(
            seed=seed_base + idx, options=_episode_options(env_id, idx)
        )
        agg = TemporalAgg(
            apply=temporal_agg, action_dim=action_dim,
            chunk_size=num_queries, k=0.01,
        )
        rewards: list = []
        success = False
        grasp = align = False
        for _ in range(max_steps):
            data = build_act_obs(obs, dataset, pad_multiple=pad_multiple)
            a_hat = np.asarray(predict(data))  # (1, nq, adim)
            action = agg(a_hat[0])
            action = (
                action * dataset.norm_stats["action_std"]
                + dataset.norm_stats["action_mean"]
            )
            obs, reward, terminated, truncated, info = ep_env.step(action)
            rewards.append(float(np.asarray(reward)))
            if staged:
                grasp = bool(info.get("is_grasped", False)) or grasp
                align = bool(info.get("pre_inserted", False)) or align
            if terminated or truncated:
                success = bool(np.asarray(info.get("success", False)))
                break
        return float(success), float(grasp), float(align), rewards

    return _drive_episodes(
        episode, env, env_factory, n_episodes, num_envs, staged, on_episode_end
    )


def maniskill2_env_kwargs(
    env_id: str,
    obs_mode: str = "pointcloud",
    control_mode: str = "pd_ee_delta_pose",
    shader_dir: str = "ibl",
    rt_samples_per_pixel: Optional[int] = None,
    rt_use_denoiser: Optional[bool] = None,
    use_stereo_depth: bool = False,
    camera_cfgs: Optional[dict] = None,
    **env_kwargs,
) -> tuple[str, dict]:
    """(env_id, gym.make kwargs) for a ManiSkill2 env, matching the
    reference's call exactly (`maniskill2_act_bc_module.py:94-108`):

    - ``shader_dir="rt"`` enables the ray tracer; ``rt_samples_per_pixel`` /
      ``rt_use_denoiser`` ride in ``render_config`` (the visual-changes
      noise sweep, `scripts/run_maniskill2_visual_changes.sh`)
    - ``use_stereo_depth`` rides in ``camera_cfgs``; ManiSkill2's camera
      parsing swaps every CameraConfig for a StereoDepthCameraConfig, and
      its env base instantiates ``StereoDepthCamera`` for those — the same
      swap the reference's vendored `sapien_env.py:407-408` performs
    - the PegInsertionSide eval remap quirk (`maniskill2_act_bc_module.py:
      95-99`) is preserved.

    Pure function (no simulator import) so it is testable in this
    environment; ``make_maniskill2_env`` consumes it.
    """
    if env_id == "PegInsertionSide-v0":
        env_id = "PegInsertionSide-3steps-v0"
    kwargs = dict(
        obs_mode=obs_mode, control_mode=control_mode, shader_dir=shader_dir,
        **env_kwargs,
    )
    render_config = {}
    if rt_samples_per_pixel is not None:
        render_config["rt_samples_per_pixel"] = int(rt_samples_per_pixel)
    if rt_use_denoiser is not None:
        render_config["rt_use_denoiser"] = bool(rt_use_denoiser)
    if render_config:
        kwargs["render_config"] = render_config
    cams = dict(camera_cfgs or {})
    if use_stereo_depth:
        cams["use_stereo_depth"] = True
    kwargs["camera_cfgs"] = cams
    return env_id, kwargs


def make_maniskill2_env(
    env_id: str,
    record_dir: Optional[str] = None,
    **kwargs,
):
    """Default env factory: real ManiSkill2 via gym registration (SAPIEN on
    the host). See ``maniskill2_env_kwargs`` for the supported knobs."""
    import gymnasium as gym
    import mani_skill2.envs  # noqa: F401  (registers envs)

    try:  # custom MultiView/lighting/background variants, when present
        import pointcloudmatters_tpu_torch.envs.custom_maniskill2  # noqa: F401
    except ImportError:
        pass

    env_id, make_kwargs = maniskill2_env_kwargs(env_id, **kwargs)
    env = gym.make(env_id, **make_kwargs)
    if record_dir is not None:
        from mani_skill2.utils.wrappers import RecordEpisode

        env = RecordEpisode(env, record_dir, info_on_video=True)
    return env


# ---------------------------------------------------------------------------
# Diffusion-policy rollouts (reference `maniskill2_dp_bc_module.py:125-306`)
# ---------------------------------------------------------------------------

def build_dp_obs(hist_obs: list, dataset, pad_multiple: int = 512) -> dict:
    """Batch-of-1 DP policy input from the last ``n_obs_steps`` raw env
    observations, reusing the train dataset's pcd/image pipelines in test
    mode (`maniskill2_dp_bc_module.py:125-222`)."""
    data: dict = {"obs": {}}
    qpos = np.stack(
        [np.asarray(o["agent"]["qpos"], np.float32) for o in hist_obs]
    )
    data["obs"]["qpos"] = qpos[None]  # (1, To, D)

    first = hist_obs[0]
    if "image" in first:
        for cam in getattr(dataset, "camera_names", list(first["image"])):
            rgb = np.stack([
                np.asarray(o["image"][cam]["rgb"], np.float32) / 255.0
                for o in hist_obs
            ])
            data["obs"][f"{cam}_rgb"] = rgb[None]  # (1, To, H, W, 3) NHWC
            if getattr(dataset, "include_depth", False):
                depth = np.stack([
                    np.asarray(o["image"][cam]["depth"], np.float32)
                    for o in hist_obs
                ])
                data["obs"][f"{cam}_depth"] = depth[None]
    elif "pointcloud" in first:
        side = int(round(dataset.point_num_per_cam ** 0.5))
        if getattr(dataset, "pointmap", False):
            frames = []
            for o in hist_obs:
                coords = np.asarray(o["pointcloud"]["xyzw"], np.float32).reshape(
                    -1, side, side, 4
                )[dataset.camera_ids].copy()
                colors = np.asarray(o["pointcloud"]["rgb"], np.float32).reshape(
                    -1, side, side, 3
                )[dataset.camera_ids] / 255.0
                colors[coords[..., -1] == 0] = 0
                coords[coords[..., -1] == 0] = 0
                frames.append(
                    np.concatenate([colors, coords[..., :3]], axis=-1)
                )
            data["obs"]["base_camera_rgb"] = np.stack(frames)[None]
        else:
            pcds = []
            for o in hist_obs:
                coords = np.asarray(o["pointcloud"]["xyzw"], np.float32).reshape(
                    -1, side, side, 4
                )[dataset.camera_ids].copy()
                if getattr(dataset, "rand_crop", False):
                    crop = int(side * 112 / 128)
                    s = (side - crop) // 2
                    coords[:, :s] = 0
                    coords[:, s + crop:] = 0
                    coords[:, :, :s] = 0
                    coords[:, :, s + crop:] = 0
                coords = coords.reshape(-1, 4)
                colors = np.asarray(o["pointcloud"]["rgb"], np.float32).reshape(
                    -1, dataset.point_num_per_cam, 3
                )[dataset.camera_ids].reshape(-1, 3)
                keep = coords[..., -1] > 0
                colors, coords = colors[keep], coords[keep][:, :3]
                keep = coords[..., -1] > 0.005
                colors, coords = colors[keep], coords[keep]
                pcds.append(dataset.transform_pcd(
                    dict(coord=coords.astype(np.float32),
                         color=colors.astype(np.float32)),
                    mode="test",
                ))
            data["obs"]["pcds"] = pad_point_clouds(pcds, pad_multiple=pad_multiple)

    goal = dataset.get_goal(first) if dataset.goal_cond_keys else None
    if goal is not None:
        data["goal"] = {
            "task_emb": np.asarray(goal, np.float32).reshape(1, -1)
        }
    return data


def run_maniskill2_dp_rollouts(
    predict: Callable[[dict], np.ndarray],
    dataset,
    env,
    env_id: str,
    n_episodes: int,
    n_obs_steps: int,
    max_steps: int = 500,
    pad_multiple: int = 512,
    seed_base: int = 10240,
    on_episode_end: Optional[Callable] = None,
) -> dict:
    """DP protocol: each prediction returns ``n_action_steps`` actions which
    are all executed before re-planning (`maniskill2_dp_bc_module.py:252-280`)."""
    successes, grasps, aligns = [], [], []
    staged = "3steps" in env_id or env_id == "PegInsertionSide-v0"
    for idx in range(n_episodes):
        options = {}
        if env_id == "TurnFaucet-v0":
            options = {"model_id": TURN_FAUCET_MODELS[idx // 40]}
        obs, _ = env.reset(seed=seed_base + idx, options=options)
        hist = [obs] * n_obs_steps
        rewards: list = []
        success = False
        grasp = align = False
        done = False
        steps = 0
        while not done and steps < max_steps:
            data = build_dp_obs(hist, dataset, pad_multiple=pad_multiple)
            actions = np.asarray(predict(data))  # (1, n_action_steps, Da)
            if actions.ndim == 2:
                actions = actions[:, None, :]
            for a_idx in range(actions.shape[1]):
                obs, reward, terminated, truncated, info = env.step(
                    actions[0, a_idx]
                )
                hist = hist[1:] + [obs]
                rewards.append(float(np.asarray(reward)))
                steps += 1
                if staged:
                    grasp = bool(info.get("is_grasped", False)) or grasp
                    align = bool(info.get("pre_inserted", False)) or align
                if terminated or truncated or steps >= max_steps:
                    success = bool(np.asarray(info.get("success", False)))
                    done = True
                    break
        successes.append(float(success))
        if staged:
            grasps.append(float(grasp))
            aligns.append(float(align))
        if on_episode_end is not None:
            on_episode_end(idx, success, rewards)
    metrics = {"mean_success": float(np.mean(successes)) if successes else 0.0}
    if staged and grasps:
        metrics["mean_grasp"] = float(np.mean(grasps))
        metrics["mean_align"] = float(np.mean(aligns))
    return metrics
