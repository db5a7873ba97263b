"""RLBench processed-episode datasets (port of
``pointcloudmatters_tpu/data/components/rlbench/datasets.py``), numpy on the
host, sample for sample the JAX package's.

- Episodes are ``.npy`` pickles written by ``scripts/preprocess_rlbench.py``:
  ``{"demo": [per-step obs dicts], "task_goal": (512,) CLIP embedding}``.
- Actions and qpos are gripper poses ``[xyz, quat (wxyz), gripper_open
  (, ignore_collisions)]``; positions are normalized to [-1, 1] by the
  task's ``loc_bounds``, quaternions normalized and turned into 6D
  rotations.
- The point-cloud variants merge the camera clouds, crop them strictly
  inside ``SCENE_BOUNDS``, optionally label the foreground by the semantic
  mask (``invalid_mask_values`` zeroed), and run ``transform_pcd``.
- The Diffusion Policy variants emit ``chunk_size``-long obs and action
  windows (edge-padded) and an identity ``LinearNormalizer`` (the
  normalization happened here).
- A sample's start step is drawn from numpy's global generator, as in JAX:
  seed it (``seed_everything``) for the same samples.

Images are NHWC float (rgb / 255).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointcloudmatters_tpu_torch.data.components.rlbench.constants import (
    SCENE_BOUNDS,
    loc_bounds,
)
from pointcloudmatters_tpu_torch.data.components.transformpcd import ComposePCD
from pointcloudmatters_tpu_torch.utils import io as io_utils
from pointcloudmatters_tpu_torch.utils.normalizer import (
    LinearNormalizer,
    SingleFieldLinearNormalizer,
)
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["RLBenchSingleTaskACTRGBDDataset", "RLBenchSingleTaskACTPCDDataset",
           "RLBenchSingleTaskDiffusionPolicyRGBDDataset",
           "RLBenchSingleTaskDiffusionPolicyPCDDataset", "quat_to_6d_np"]

log = RankedLogger(__name__, rank_zero_only=True)


# -- numpy rotation helpers (host-side; the torch versions live in
# utils/rotation_conversions.py) --------------------------------------------

def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> (..., 3, 3)."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    two_s = 2.0 / np.sum(q * q, axis=-1)
    m = np.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_to_6d_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz -> (..., 6): first two matrix rows."""
    m = _quat_to_matrix_np(q)
    return m[..., :2, :].reshape(q.shape[:-1] + (6,))


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


class RLBenchSingleTaskACTRGBDDataset:
    def __init__(
        self,
        root: str = "data/rlbench/processed/train/",
        task_names: Sequence[str] = (),
        chunk_size: int = 16,
        max_episodes_per_task: int = 100,
        cameras: Tuple[str, ...] = ("front",),
        action_dim: int = 11,
        include_depth: bool = False,
        rot_type: str = "6d",
        collision: bool = True,
        use_mask: bool = False,
        invalid_mask_values: Sequence[int] = (201, 204, 208, 246),
        loop: int = 1,
        cache_episode: bool = True,
        use_pcd: bool = False,
        **kwargs,
    ):
        assert rot_type == "6d", f"rot_type {rot_type} not supported"
        self.root = root
        self.cameras = tuple(cameras)
        self.chunk_size = chunk_size
        self.task_names = list(task_names)
        self.action_dim = action_dim
        self.include_depth = include_depth
        self.rot_type = rot_type
        self.collision = collision
        self.use_mask = use_mask
        self.invalid_mask_values = list(invalid_mask_values)
        self.loop = loop
        self.cache_episode = cache_episode
        self.use_pcd = use_pcd

        self.episodes: List[Tuple[str, Any]] = []
        for task_n in self.task_names:
            count = 0
            task_dir = os.path.join(root, task_n)
            for filename in sorted(os.listdir(task_dir)):
                if not filename.endswith("npy") or "old" in filename:
                    continue
                path = os.path.join(task_dir, filename)
                if self.cache_episode:
                    data = io_utils.load_numpy_pickle(path)
                    for demo in data["demo"]:
                        if not self.include_depth:
                            for cam in self.cameras:
                                demo.pop(f"{cam}_depth", None)
                        if not self.use_pcd:
                            for cam in self.cameras:
                                demo.pop(f"{cam}_point_cloud", None)
                    self.episodes.append((task_n, data))
                else:
                    self.episodes.append((task_n, path))
                count += 1
                if count >= max_episodes_per_task:
                    break
        log.info(f"Created dataset from {root} with {len(self.episodes)}.")

    def __len__(self):
        return len(self.episodes) * self.loop

    # -- shared pieces ------------------------------------------------------
    def _episode(self, idx: int):
        task, episode = self.episodes[idx % len(self.episodes)]
        if not self.cache_episode:
            episode = io_utils.load_numpy_pickle(episode)
        return task, episode

    def _pose_vec(self, obs: dict) -> np.ndarray:
        parts = [np.asarray(obs["gripper_pose"], np.float32),
                 np.asarray([obs["gripper_open"]], np.float32)]
        if self.collision:
            parts.append(np.asarray([obs["ignore_collisions"]], np.float32))
        return np.concatenate(parts)

    def _action_chunk(self, demo, start: int):
        actions = np.stack([
            self._pose_vec(d) for d in demo[start: start + self.chunk_size]
        ]).astype(np.float32)
        n = len(actions)
        padded = np.zeros((self.chunk_size, actions.shape[1]), np.float32)
        padded[:n] = actions
        is_pad = np.zeros(self.chunk_size, bool)
        is_pad[n:] = True
        return padded, is_pad, n

    def _edge_pad(self, arr: np.ndarray) -> np.ndarray:
        """The DP variants' windows: ``arr`` edge-padded to ``chunk_size`` rows."""
        if len(arr) < self.chunk_size:
            pad = [[0, self.chunk_size - len(arr)]] + [[0, 0]] * (arr.ndim - 1)
            arr = np.pad(arr, pad, mode="edge")
        return arr.astype(np.float32)

    def _window(self, demo, start: int):
        """(the steps, their edge-padded qpos, the action chunk, its length)."""
        steps = demo[start: start + self.chunk_size]
        qpos = self._edge_pad(np.stack([self._pose_vec(o) for o in steps]))
        action, is_pad, n = self._action_chunk(demo, start)
        return steps, qpos, action, n

    def _normalize_pose(self, task: str, qpos: np.ndarray, action: np.ndarray,
                        action_len: int):
        """loc-bounds position normalization + quat -> 6D
        (`rlbench_single_task_act.py:168-199`)."""
        pos_min, pos_max = (np.asarray(b, np.float32) for b in loc_bounds[task])
        qpos = qpos.copy()
        action = action.copy()
        qpos[:3] = (qpos[:3] - pos_min) / (pos_max - pos_min) * 2.0 - 1.0
        action[:action_len, :3] = (
            (action[:action_len, :3] - pos_min) / (pos_max - pos_min) * 2.0 - 1.0
        )
        qpos[3:7] = _normalize_rows(qpos[3:7])
        action[:action_len, 3:7] = _normalize_rows(action[:action_len, 3:7])

        q_rot = quat_to_6d_np(qpos[3:7])
        a_rot = np.zeros((action.shape[0], 6), np.float32)
        a_rot[:action_len] = quat_to_6d_np(action[:action_len, 3:7])
        qpos_out = np.concatenate([qpos[:3], q_rot, qpos[7:]], -1)
        action_out = np.concatenate([action[..., :3], a_rot, action[..., 7:]], -1)
        return qpos_out.astype(np.float32), action_out.astype(np.float32)

    def _merged_cloud(self, obs: dict):
        """Merge cameras, crop to SCENE_BOUNDS, optional fg-mask labeling
        (`rlbench_single_task_act.py:264-311`)."""
        colors = np.concatenate([
            np.asarray(obs[f"{cam}_rgb"], np.float32).reshape(-1, 3)
            for cam in self.cameras
        ])
        coords = np.concatenate([
            np.asarray(obs[f"{cam}_point_cloud"], np.float32).reshape(-1, 3)
            for cam in self.cameras
        ])
        keep = (
            (coords[:, 0] > SCENE_BOUNDS[0]) & (coords[:, 0] < SCENE_BOUNDS[3])
            & (coords[:, 1] > SCENE_BOUNDS[1]) & (coords[:, 1] < SCENE_BOUNDS[4])
            & (coords[:, 2] > SCENE_BOUNDS[2]) & (coords[:, 2] < SCENE_BOUNDS[5])
        )
        coords, colors = coords[keep], colors[keep]
        if not self.use_mask:
            return self.transform_pcd(dict(coord=coords, color=colors))
        masks = np.concatenate([
            np.asarray(obs[f"{cam}_mask"], np.float32).reshape(-1)
            for cam in self.cameras
        ])[keep]
        for v in self.invalid_mask_values:
            masks[masks == v] = 0
        masks = (masks > 0).astype(np.float32)
        pcd = self.transform_pcd(dict(
            coord=coords,
            color=np.concatenate([colors, masks[:, None]], -1),
        ))
        pcd["mask"] = pcd["feat"][:, -1].astype(bool)
        pcd["feat"] = pcd["feat"][:, :-1]
        return pcd

    def _images(self, obs: dict) -> np.ndarray:
        images = []
        for cam in self.cameras:
            img = np.asarray(obs[f"{cam}_rgb"], np.float32)
            img = img / 255.0
            if self.include_depth:
                depth = np.asarray(obs[f"{cam}_depth"], np.float32)[..., None]
                img = np.concatenate([img, depth], -1)
            images.append(img)
        return np.stack(images)  # (ncam, H, W, C) NHWC

    def __getitem__(self, idx):
        task, episode = self._episode(idx)
        demo, goal_cond = episode["demo"], episode["task_goal"]
        start_ts = np.random.choice(len(demo) - 1)
        obs = demo[start_ts]
        qpos = self._pose_vec(obs)
        action, is_pad, n = self._action_chunk(demo, start_ts + 1)
        qpos, action = self._normalize_pose(task, qpos, action, n)
        return dict(
            image=self._images(obs),
            qpos=qpos,
            actions=action,
            is_pad=is_pad,
            goal_cond=np.asarray(goal_cond, np.float32),
        )


class RLBenchSingleTaskACTPCDDataset(RLBenchSingleTaskACTRGBDDataset):
    def __init__(self, transform_pcd: Optional[List[Dict[str, Any]]] = None,
                 **kwargs):
        kwargs.pop("use_pcd", None)
        super().__init__(use_pcd=True, **kwargs)
        self.transform_pcd = (
            transform_pcd if isinstance(transform_pcd, ComposePCD)
            else ComposePCD(transform_pcd)
        )

    def __getitem__(self, idx):
        task, episode = self._episode(idx)
        demo, goal_cond = episode["demo"], episode["task_goal"]
        start_ts = np.random.choice(len(demo) - 1)
        obs = demo[start_ts]
        qpos = self._pose_vec(obs)
        action, is_pad, n = self._action_chunk(demo, start_ts + 1)
        qpos, action = self._normalize_pose(task, qpos, action, n)
        return dict(
            pcds=[self._merged_cloud(obs)],
            qpos=qpos,
            actions=action,
            is_pad=is_pad,
            goal_cond=np.asarray(goal_cond, np.float32),
        )


class RLBenchSingleTaskDiffusionPolicyRGBDDataset(RLBenchSingleTaskACTRGBDDataset):
    """DP variant (`rlbench_single_task_dp.py:28`): chunk-long obs windows,
    identity normalizer (loc-bounds normalization already applied here)."""

    def __init__(self, n_obs_steps: int = 2, **kwargs):
        self.n_obs_steps = n_obs_steps
        super().__init__(**kwargs)
        self.obs_keys = ["qpos"] + [f"{cam}_rgb" for cam in self.cameras]
        if self.include_depth:
            self.obs_keys += [f"{cam}_depth" for cam in self.cameras]

    def get_normalizer(self, **kwargs) -> LinearNormalizer:
        normalizer = LinearNormalizer()
        normalizer["action"] = SingleFieldLinearNormalizer.create_identity()
        for k in self.obs_keys:
            normalizer[k] = SingleFieldLinearNormalizer.create_identity()
        return normalizer

    def __getitem__(self, idx):
        task, episode = self._episode(idx)
        demo, goal_cond = episode["demo"], episode["task_goal"]
        start_ts = np.random.choice(len(demo) - 1)
        steps, qpos_win, action, n = self._window(demo, start_ts)
        # normalize each window row with the same task bounds
        rows = [self._normalize_pose(task, q, action, n) for q in qpos_win]
        qpos_norm = np.stack([r[0] for r in rows])
        _, action_norm = self._normalize_pose(task, qpos_win[0], action, n)

        obs_dict: dict = {"qpos": qpos_norm}
        for cam in self.cameras:
            rgb = self._edge_pad(np.stack([
                np.asarray(o[f"{cam}_rgb"], np.float32) / 255.0 for o in steps
            ]))
            obs_dict[f"{cam}_rgb"] = rgb
            if self.include_depth:
                depth = self._edge_pad(np.stack([
                    np.asarray(o[f"{cam}_depth"], np.float32)[..., None]
                    for o in steps
                ]))
                obs_dict[f"{cam}_depth"] = depth
        return dict(
            obs=obs_dict,
            action=action_norm,
            goal={"task_emb": np.asarray(goal_cond, np.float32)},
        )


class RLBenchSingleTaskDiffusionPolicyPCDDataset(RLBenchSingleTaskACTPCDDataset):
    """`rlbench_single_task_dp.py:179`."""

    def __init__(self, n_obs_steps: int = 2, **kwargs):
        self.n_obs_steps = n_obs_steps
        super().__init__(**kwargs)
        self.obs_keys = ["qpos", "pcds"]

    def get_normalizer(self, **kwargs) -> LinearNormalizer:
        normalizer = LinearNormalizer()
        normalizer["action"] = SingleFieldLinearNormalizer.create_identity()
        normalizer["qpos"] = SingleFieldLinearNormalizer.create_identity()
        return normalizer

    def __getitem__(self, idx):
        task, episode = self._episode(idx)
        demo, goal_cond = episode["demo"], episode["task_goal"]
        start_ts = np.random.choice(len(demo) - 1)
        _, qpos_win, action, n = self._window(demo, start_ts)
        rows = [self._normalize_pose(task, q, action, n) for q in qpos_win]
        qpos_norm = np.stack([r[0] for r in rows])
        _, action_norm = self._normalize_pose(task, qpos_win[0], action, n)

        pcds = []
        for step in range(self.n_obs_steps):
            ts = min(start_ts + step, len(demo) - 1)
            pcds.append(self._merged_cloud(demo[ts]))
        return dict(
            obs={"qpos": qpos_norm, "pcds": pcds},
            action=action_norm,
            goal={"task_emb": np.asarray(goal_cond, np.float32)},
        )
