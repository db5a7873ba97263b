"""ManiSkill2 replayed-trajectory datasets for ACT over point clouds and
images and for the Diffusion Policy over point clouds (port of
``pointcloudmatters_tpu/data/components/maniskill2.py:54-397, 400-498``),
numpy on the host.

- A sample draws a random start timestep, takes the action chunk of
  ``chunk_size`` future actions with an ``is_pad`` tail mask, z-scores qpos
  and actions by per-task statistics (cached as ``.npz`` under
  ``cache_dir``, keyed by ``env_id``), and adds the goal from
  ``obs["extra"][goal_cond_keys]``.
- A Diffusion Policy sample takes edge-padded chunks of ``qpos`` and
  actions, unnormalized (the policy normalizes them: :meth:`get_normalizer`,
  from min/max statistics cached beside the ACT ones with the tag
  ``_dp``), and ``n_obs_steps`` clouds from the start step on under
  ``obs.pcds`` (the last frame repeated past the episode's end).
- The point cloud merges the selected cameras, drops ``w <= 0`` points and
  the ground (``z <= 0.005``; with ``include_ground`` it keeps the ground
  and masks the foreground), optionally zeroes all but a random 112^2 crop
  (``rand_crop``), and goes through ``transform_pcd``; with ``pointmap`` it
  is a 6-channel image instead.
- An RGB-D sample stacks each camera's image at the start step (k, h, w, c)
  under ``image``: RGB scaled by 1/255, with ``include_depth`` the depth
  channel after it scaled by 2^-10 (unless ``scale_rgb_only``), with
  ``only_depth`` the scaled depth alone; a camera named ``base_*`` that the
  demo lacks is read from ``front_*``.

Every read of the demo file (``h5py`` and the json beside it) is
:meth:`_ManiSkill2TrajectoryDataset._read_file`.
"""

from __future__ import annotations

import logging
import os
from os.path import expanduser

import numpy as np

from pointcloudmatters_tpu_torch.data.components.transformpcd import ComposePCD
from pointcloudmatters_tpu_torch.utils import io as io_utils
from pointcloudmatters_tpu_torch.utils.normalizer import (
    LinearNormalizer,
    SingleFieldLinearNormalizer,
    get_range_normalizer_from_stat,
)

__all__ = ["ManiSkill2GoalPosSingleTaskACTPCDDataset",
           "ManiSkill2NullGoalSingleTaskACTPCDDataset",
           "ManiSkill2GoalPosSingleTaskACTRGBDDataset",
           "ManiSkill2NullGoalSingleTaskACTRGBDDataset",
           "ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset",
           "ManiSkill2NullGoalSingleTaskDiffusionPolicyPCDDataset"]

log = logging.getLogger(__name__)

_DEFAULT_CACHE = os.path.join(expanduser("~"), ".cache", "pcm_tpu")


class _ManiSkill2TrajectoryDataset:
    """Trajectory loading and caching, and the z-score statistics."""

    def __init__(
        self,
        dataset_file: str,
        load_count=-1,
        goal_cond_keys=None,
        chunk_size: int = 100,
        cache_dir: str = _DEFAULT_CACHE,
        cache_traj: bool = True,
        loop: int = 1,
    ):
        self.dataset_file = dataset_file
        self.json_data, _ = self._read_file(())
        self.episodes = self.json_data["episodes"]
        self.env_info = self.json_data["env_info"]
        self.env_id = self.env_info["env_id"]
        self.env_kwargs = self.env_info["env_kwargs"]
        self.loop = loop
        self.goal_cond_keys = goal_cond_keys
        self.chunk_size = chunk_size
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self.cache_traj = cache_traj

        if load_count == -1:
            load_count = len(self.episodes)
        elif isinstance(load_count, float):
            load_count = int(load_count * len(self.episodes))
        self.load_count = load_count

        if cache_traj:
            _, trajs = self._read_file(
                [eps["episode_id"] for eps in self.episodes[:load_count]])
            self.trajectories = [self._trim(t) for t in trajs]
        self.norm_stats = self.get_norm_stats()

    def _read_file(self, episode_ids) -> tuple[dict, list[dict]]:
        """The demo file's json (episodes, env info) and the trajectories of
        ``episode_ids``, each as nested dicts of numpy arrays."""
        import h5py

        json_data = io_utils.load_json(self.dataset_file.replace(".h5", ".json"))
        if not episode_ids:
            return json_data, []
        with h5py.File(self.dataset_file, "r") as data:
            return json_data, [io_utils.load_h5_data(data[f"traj_{i}"]) for i in episode_ids]

    @staticmethod
    def _trim(traj: dict) -> dict:
        # drop the bulky streams no sample reads, as the reference does
        traj["obs"].get("agent", {}).pop("qvel", None)
        traj["obs"].get("agent", {}).pop("base_pose", None)
        traj["obs"].pop("camera_param", None)
        return traj

    def _episode_for_index(self, idx: int):
        if self.load_count == len(self.episodes):
            return self.episodes[idx]
        stride = int(np.floor(len(self.episodes) / self.load_count))
        return self.episodes[::stride][idx]

    def _trajectory(self, idx: int) -> dict:
        if self.cache_traj:
            return self.trajectories[idx]
        _, (traj,) = self._read_file([self._episode_for_index(idx)["episode_id"]])
        return self._trim(traj)

    def __len__(self):
        return self.load_count * self.loop

    def _stats_cache_path(self, tag: str = "") -> str:
        suffix = "" if self.load_count == len(self.episodes) else f"_sample_{self.load_count}"
        return os.path.join(self.cache_dir, f"{self.env_id}_norm_stats{tag}{suffix}.npz")

    def _all_qpos_action(self):
        qpos, action = [], []
        for i in range(self.load_count):
            traj = self._trajectory(i)
            qpos.append(traj["obs"]["agent"]["qpos"])
            action.append(traj["actions"])
        return np.concatenate(qpos, 0), np.concatenate(action, 0)

    def get_norm_stats(self) -> dict:
        """qpos and action means and standard deviations (at least 1e-2),
        from the cache file of this ``env_id`` when there is one."""
        path = self._stats_cache_path()
        if os.path.exists(path):
            log.info("Loading normalization stats from cache...")
            return dict(np.load(path))
        log.info(f"Calculating normalization stats -> {path}")
        all_qpos, all_action = self._all_qpos_action()
        stats = {
            "action_mean": all_action.mean(0),
            "action_std": np.clip(all_action.std(0), 1e-2, np.inf),
            "qpos_mean": all_qpos.mean(0),
            "qpos_std": np.clip(all_qpos.std(0), 1e-2, np.inf),
        }
        np.savez(path, **stats)
        return stats

    def get_goal(self, obs) -> np.ndarray:
        goal_conds = []
        for key in self.goal_cond_keys:
            goal = np.asarray(obs["extra"][key], np.float32)
            if key == "target_angle_diff":
                goal = goal[..., None]
            if "target_angle_diff" in self.goal_cond_keys and goal.ndim == 1:
                goal = goal[None, :]
            goal_conds.append(goal)
        return np.concatenate(goal_conds, axis=-1)

    def _extract_pcd(self, trajectory: dict, ts: int, mode: str = "train"):
        """The transformed pcd dict of timestep ``ts``, or a 6-channel
        pointmap image (k, h, w, 6) with ``self.pointmap``."""
        side = int(round(self.point_num_per_cam ** 0.5))  # 128 on real data
        coords = trajectory["obs"]["pointcloud"]["xyzw"][ts].reshape(-1, side, side, 4)[
            self.camera_ids
        ]
        if self.pointmap:
            colors = (
                trajectory["obs"]["pointcloud"]["rgb"][ts]
                .reshape(-1, side, side, 3)[self.camera_ids]
                .astype(float) / 255.0
            )
            colors[coords[..., -1] == 0] = 0
            coords = np.where(coords[..., -1:] == 0, 0, coords)[..., :3]
            image = np.concatenate([colors, coords], axis=-1).reshape(-1, side, side, 6)
            return image.astype(np.float32)

        coords = coords.copy()
        if self.rand_crop and mode == "train":
            crop = int(side * 112 / 128)
            cx = np.random.randint(0, side - crop)
            cy = np.random.randint(0, side - crop)
            coords[:, :cx] = 0
            coords[:, cx + crop:] = 0
            coords[:, :, :cy] = 0
            coords[:, :, cy + crop:] = 0
        coords = coords.reshape(-1, 4)
        colors = (
            trajectory["obs"]["pointcloud"]["rgb"][ts]
            .reshape(-1, self.point_num_per_cam, 3)[self.camera_ids]
            .reshape(-1, 3)
        )
        keep = coords[..., -1] > 0
        colors, coords = colors[keep], coords[keep][:, :3]
        if not self.include_ground:
            keep = coords[..., -1] > 0.005
        else:
            keep = coords[..., 0] > -0.8
        colors, coords = colors[keep], coords[keep]
        pcd = self.transform_pcd(
            dict(coord=coords.astype(np.float32), color=colors.astype(np.float32)),
            mode=mode,
        )
        if self.include_ground:
            pcd["mask"] = pcd["coord"][:, -1] > 0.005
        return pcd

    def _action_chunk_with_pad(self, trajectory, start_ts):
        actions = trajectory["actions"]
        chunk = actions[start_ts: start_ts + self.chunk_size]
        padded = np.zeros((self.chunk_size, actions.shape[1]), np.float32)
        padded[: len(chunk)] = chunk
        is_pad = np.zeros(self.chunk_size, bool)
        is_pad[len(chunk):] = True
        return padded, is_pad


class ManiSkill2GoalPosSingleTaskACTPCDDataset(_ManiSkill2TrajectoryDataset):
    """The ACT point-cloud dataset (reference
    ``maniskill2_single_task_pcd_act.py:18``)."""

    def __init__(
        self,
        dataset_file: str,
        load_count=-1,
        goal_cond_keys=None,
        chunk_size=100,
        transform_pcd=None,
        cache_dir=_DEFAULT_CACHE,
        camera_ids=(0,),
        point_num_per_cam=16384,
        include_ground=False,
        cache_traj=True,
        rand_crop=False,
        pointmap=False,
        loop=1,
    ):
        self.camera_ids = list(camera_ids)
        self.point_num_per_cam = point_num_per_cam
        self.include_ground = include_ground
        self.rand_crop = rand_crop
        self.pointmap = pointmap
        self.transform_pcd = transform_pcd if isinstance(transform_pcd, ComposePCD) \
            else ComposePCD(transform_pcd)
        super().__init__(
            dataset_file=dataset_file, load_count=load_count,
            goal_cond_keys=goal_cond_keys, chunk_size=chunk_size,
            cache_dir=cache_dir, cache_traj=cache_traj, loop=loop,
        )

    def __getitem__(self, idx):
        idx = idx % self.load_count
        trajectory = self._trajectory(idx)
        episode_len = trajectory["actions"].shape[0]
        start_ts = np.random.choice(episode_len)

        qpos = trajectory["obs"]["agent"]["qpos"][start_ts].astype(np.float32)
        qpos = (qpos - self.norm_stats["qpos_mean"]) / self.norm_stats["qpos_std"]
        padded_action, is_pad = self._action_chunk_with_pad(trajectory, start_ts)
        action = (padded_action - self.norm_stats["action_mean"]) / self.norm_stats["action_std"]
        goal_cond = np.asarray(self.get_goal(trajectory["obs"])[start_ts], np.float32)

        obs = self._extract_pcd(trajectory, start_ts)
        data = dict(
            qpos=qpos.astype(np.float32),
            actions=action.astype(np.float32),
            is_pad=is_pad,
            goal_cond=goal_cond,
        )
        if self.pointmap:
            data["image"] = obs
        else:
            data["pcds"] = [obs]
        return data


class ManiSkill2NullGoalSingleTaskACTPCDDataset(ManiSkill2GoalPosSingleTaskACTPCDDataset):
    """A zero goal vector of width 1000 (reference
    ``maniskill2_single_task_pcd_act.py:288``)."""

    def __init__(self, dataset_file, load_count=-1, chunk_size=20, transform_pcd=None,
                 cache_dir=_DEFAULT_CACHE, camera_ids=(0,), point_num_per_cam=16384,
                 include_ground=False, loop=1, **kwargs):
        super().__init__(
            dataset_file=dataset_file, load_count=load_count, chunk_size=chunk_size,
            transform_pcd=transform_pcd, cache_dir=cache_dir, camera_ids=camera_ids,
            point_num_per_cam=point_num_per_cam, include_ground=include_ground,
            loop=loop, **kwargs,
        )

    def get_goal(self, obs):
        n = len(obs["agent"]["qpos"])
        return np.zeros((n, 1000), np.float32)


class ManiSkill2GoalPosSingleTaskACTRGBDDataset(_ManiSkill2TrajectoryDataset):
    """The ACT RGB(-D) dataset (reference
    ``maniskill2_single_task_rgbd_act.py:17``); images stay channel-last."""

    def __init__(
        self,
        dataset_file: str,
        load_count=-1,
        camera_names=("base_camera",),
        include_depth=False,
        scale_rgb_only=False,
        goal_cond_keys=("goal_pos", "obj_start_pos"),
        chunk_size=100,
        cache_dir=_DEFAULT_CACHE,
        only_depth=False,
        cache_traj=True,
        loop=1,
    ):
        self.camera_names = camera_names
        self.include_depth = include_depth
        self.scale_rgb_only = scale_rgb_only
        self.only_depth = only_depth
        super().__init__(
            dataset_file=dataset_file, load_count=load_count,
            goal_cond_keys=goal_cond_keys, chunk_size=chunk_size,
            cache_dir=cache_dir, cache_traj=cache_traj, loop=loop,
        )

    def _camera_image(self, trajectory, camera_name, ts):
        images = trajectory["obs"]["image"]
        data_cam = camera_name if camera_name in images else camera_name.replace("base", "front")
        assert data_cam in images, f"Camera {camera_name} not found; have {list(images)}"
        cam = images[data_cam]
        ts = min(ts, len(cam["depth" if self.only_depth else "rgb"]) - 1)
        if self.only_depth:
            return cam["depth"].astype(np.float32)[ts]
        rgb = cam["rgb"].astype(np.float32)
        if self.include_depth:
            return np.concatenate([rgb, cam["depth"].astype(np.float32)], axis=-1)[ts]
        return rgb[ts]

    def _scale_image(self, image_khwc: np.ndarray) -> np.ndarray:
        img = image_khwc.astype(np.float32).copy()
        if self.only_depth:
            img[..., :1] = img[..., :1] / (2**10)
        else:
            img[..., :3] = img[..., :3] / 255.0
            if self.include_depth and not self.scale_rgb_only:
                img[..., 3:] = img[..., 3:] / (2**10)
        return img

    def __getitem__(self, idx):
        idx = idx % self.load_count
        trajectory = self._trajectory(idx)
        episode_len = trajectory["actions"].shape[0]
        start_ts = np.random.choice(episode_len)

        images = np.stack(
            [self._camera_image(trajectory, cam, start_ts) for cam in self.camera_names])
        qpos = trajectory["obs"]["agent"]["qpos"][start_ts].astype(np.float32)
        qpos = (qpos - self.norm_stats["qpos_mean"]) / self.norm_stats["qpos_std"]
        padded_action, is_pad = self._action_chunk_with_pad(trajectory, start_ts)
        action = (padded_action - self.norm_stats["action_mean"]) / self.norm_stats["action_std"]
        goal_cond = np.asarray(self.get_goal(trajectory["obs"])[start_ts], np.float32)
        return dict(
            image=self._scale_image(images),
            qpos=qpos.astype(np.float32),
            actions=action.astype(np.float32),
            is_pad=is_pad,
            goal_cond=goal_cond,
        )


class ManiSkill2NullGoalSingleTaskACTRGBDDataset(ManiSkill2GoalPosSingleTaskACTRGBDDataset):
    """A zero goal vector of width 1000."""

    def __init__(self, dataset_file, load_count=-1, camera_names=("base_camera",),
                 include_depth=False, scale_rgb_only=False, goal_cond_keys=None,
                 only_depth=False, chunk_size=20, loop=1, **kwargs):
        super().__init__(
            dataset_file=dataset_file, load_count=load_count, camera_names=camera_names,
            include_depth=include_depth, scale_rgb_only=scale_rgb_only,
            goal_cond_keys=goal_cond_keys, chunk_size=chunk_size,
            only_depth=only_depth, loop=loop, **kwargs,
        )

    def get_goal(self, obs):
        n = len(obs["agent"]["qpos"])
        return np.zeros((n, 1000), np.float32)


class _DPStatsMixin:
    """The Diffusion Policy's min/max statistics and its normalizer."""

    def get_norm_stats(self) -> dict:
        path = self._stats_cache_path(tag="_dp")
        if os.path.exists(path):
            log.info("Loading normalization stats from cache...")
            return io_utils.load_npz_dict(path)
        log.info(f"Calculating DP normalization stats -> {path}")
        all_qpos, all_action = self._all_qpos_action()
        stats = {
            name: {"min": arr.min(0), "max": arr.max(0), "mean": arr.mean(0),
                   "std": np.maximum(arr.std(0), 1e-2)}
            for name, arr in (("action", all_action), ("qpos", all_qpos))
        }
        io_utils.save_npz_dict(path, stats)
        return stats

    def get_normalizer(self, **kwargs) -> LinearNormalizer:
        """``action`` and ``qpos`` to [-1, 1] by their ranges; images (and
        a pointmap's) unchanged."""
        stats = self.get_norm_stats()
        normalizer = LinearNormalizer()
        normalizer["action"] = get_range_normalizer_from_stat(stats["action"], **kwargs)
        for k in self.obs_keys:
            if "pcd" in k:
                if self.pointmap:
                    normalizer["base_camera_rgb"] = SingleFieldLinearNormalizer.create_identity()
                continue
            if "rgb" in k or "depth" in k:
                normalizer[k] = SingleFieldLinearNormalizer.create_identity()
            elif "qpos" in k:
                normalizer[k] = get_range_normalizer_from_stat(stats["qpos"], **kwargs)
            else:
                raise ValueError(f"Unknown key {k}")
        return normalizer

    def _chunk_edge_padded(self, arr, start_ts):
        chunk = arr[start_ts: start_ts + self.chunk_size]
        if len(chunk) < self.chunk_size:
            pad = [[0, self.chunk_size - len(chunk)]] + [[0, 0]] * (chunk.ndim - 1)
            chunk = np.pad(chunk, pad, mode="edge")
        return chunk.astype(np.float32)


class ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset(
        _DPStatsMixin, ManiSkill2GoalPosSingleTaskACTPCDDataset):
    """The Diffusion Policy point-cloud dataset (reference
    ``maniskill2_single_task_pcd_dp.py:18``); coordinates and colours of a
    history frame are both read at its own timestep (the reference reads the
    colours one frame on, which the JAX package fixed)."""

    def __init__(self, n_obs_steps=2, **kwargs):
        self.n_obs_steps = n_obs_steps
        self.obs_keys = ["qpos", "pcds"]
        super().__init__(**kwargs)

    def __getitem__(self, idx):
        idx = idx % self.load_count
        trajectory = self._trajectory(idx)
        episode_len = trajectory["actions"].shape[0]
        start_ts = np.random.choice(episode_len)

        obs_dict = {"qpos": self._chunk_edge_padded(trajectory["obs"]["agent"]["qpos"], start_ts)}
        n_frames = len(trajectory["obs"]["pointcloud"]["xyzw"])
        obs_pcds = []
        for step in range(self.n_obs_steps):
            ts = start_ts + step
            if ts >= n_frames:
                assert obs_pcds, (step, n_frames)
                obs_pcds.append(obs_pcds[-1])
            else:
                obs_pcds.append(self._extract_pcd(trajectory, ts))
        if self.pointmap:
            obs_dict["base_camera_rgb"] = np.concatenate(obs_pcds, axis=0)
        else:
            obs_dict["pcds"] = obs_pcds

        out = {"obs": obs_dict, "action": self._chunk_edge_padded(trajectory["actions"], start_ts)}
        goal_cond = self.get_goal(trajectory["obs"])
        if goal_cond is not None:
            out["goal"] = dict(task_emb=np.asarray(goal_cond[start_ts], np.float32))
        return out


class ManiSkill2NullGoalSingleTaskDiffusionPolicyPCDDataset(
        ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset):
    """No goal."""

    def get_goal(self, obs):
        return None
