"""RLBench helpers (port of ``pointcloudmatters_tpu/utils/rlbench_utils.py``;
the reference's `src/utils/rlbench_utils.py:21-353`).

The simulator's pieces (CoppeliaSim, PyRep, RLBench) are imported where
they are called, and only there: ``build_env_and_task`` and ``reset_task``
are the seam that a fake task replaces. The observation conversion follows
the dataset pipeline (loc-bounds pose normalization, the strict
``SCENE_BOUNDS`` crop, semantic-mask labelling) and emits padded batches.

Text goals: the reference loads CLIP ViT-B/16 at evaluation
(`rlbench_utils.py:119-125`). ``build_text_encoder`` tries CLIP, then an
embedding cache written when CLIP ran (``CachedTextEncoder``, sha1 keys),
then a deterministic hash (``HashTextEncoder``, for smoke tests): a choice
of text encoder, in JAX's order. The evaluation never needs a download.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from pointcloudmatters_tpu_torch.data.collate import pad_point_clouds
from pointcloudmatters_tpu_torch.data.components.rlbench.constants import (
    SCENE_BOUNDS,
    loc_bounds,
)
from pointcloudmatters_tpu_torch.data.components.rlbench.datasets import (
    _normalize_rows,
    quat_to_6d_np,
)
from pointcloudmatters_tpu_torch.data.components.transformpcd import ComposePCD
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

ALL_TASKS = [
    "basketball_in_hoop", "beat_the_buzz", "change_channel", "change_clock",
    "close_box", "close_door", "close_drawer", "close_fridge", "close_grill",
    "close_jar", "close_laptop_lid", "close_microwave",
    "hang_frame_on_hanger", "insert_onto_square_peg",
    "insert_usb_in_computer", "lamp_off", "lamp_on", "lift_numbered_block",
    "light_bulb_in", "meat_off_grill", "meat_on_grill", "move_hanger",
    "open_box", "open_door", "open_drawer", "open_fridge", "open_grill",
    "open_microwave", "open_oven", "open_window", "open_wine_bottle",
    "phone_on_base", "pick_and_lift", "pick_and_lift_small", "pick_up_cup",
    "place_cups", "place_hanger_on_rack", "place_shape_in_shape_sorter",
    "place_wine_at_rack_location", "play_jenga",
    "plug_charger_in_power_supply", "press_switch", "push_button",
    "push_buttons", "put_books_on_bookshelf", "put_groceries_in_cupboard",
    "put_item_in_drawer", "put_knife_on_chopping_board", "put_money_in_safe",
    "put_rubbish_in_bin", "put_umbrella_in_umbrella_stand", "reach_and_drag",
    "reach_target", "scoop_with_spatula", "screw_nail", "setup_checkers",
    "slide_block_to_color_target", "slide_block_to_target",
    "slide_cabinet_open_and_place_cups", "stack_blocks", "stack_cups",
    "stack_wine", "straighten_rope", "sweep_to_dustpan",
    "sweep_to_dustpan_of_size", "take_frame_off_hanger",
    "take_lid_off_saucepan", "take_money_out_safe",
    "take_plate_off_colored_dish_rack", "take_shoes_out_of_box",
    "take_toilet_roll_off_stand", "take_umbrella_out_of_umbrella_stand",
    "take_usb_out_of_computer", "toilet_seat_down", "toilet_seat_up",
    "tower3", "turn_oven_on", "turn_tap", "tv_on", "unplug_charger",
    "water_plants", "wipe_desk",
]
TASK_TO_ID = {task: i for i, task in enumerate(ALL_TASKS)}

DEFAULT_INVALID_MASK_VALUES = [
    201, 202, 203, 204, 205, 206, 207, 208, 209, 210, 211, 212, 213, 214,
    215, 246,
]


# ---------------------------------------------------------------------------
# Text goal encoding
# ---------------------------------------------------------------------------

class TextEncoder:
    """Encode a task description to a (512,) goal embedding."""

    def encode(self, text: str) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class ClipTextEncoder(TextEncoder):
    def __init__(self, clip_model: str = "ViT-B/16"):
        import clip
        import torch

        device = "cuda" if torch.cuda.is_available() else "cpu"
        self.model, _ = clip.load(clip_model, device=device,
                                  download_root="./.cache/clip")
        self.model.requires_grad_(False)
        self.model.eval()
        self.device = device
        self._clip = clip

    def encode(self, text: str) -> np.ndarray:
        import torch

        with torch.no_grad():
            tok = self._clip.tokenize(text).to(self.device)
            return (
                self.model.encode_text(tok).reshape(-1).float().cpu().numpy()
            )


class CachedTextEncoder(TextEncoder):
    """Looks text up in an npz cache keyed by a stable text hash — written by
    the preprocess script when CLIP was available."""

    def __init__(self, cache_path: str):
        self.cache_path = cache_path
        self._cache = dict(np.load(cache_path)) if os.path.exists(cache_path) else {}

    @staticmethod
    def key(text: str) -> str:
        return hashlib.sha1(text.strip().lower().encode()).hexdigest()

    def encode(self, text: str) -> np.ndarray:
        k = self.key(text)
        if k not in self._cache:
            raise KeyError(f"text {text!r} not in embedding cache {self.cache_path}")
        return np.asarray(self._cache[k], np.float32)

    def put(self, text: str, embedding: np.ndarray) -> None:
        self._cache[self.key(text)] = np.asarray(embedding, np.float32)

    def save(self) -> None:
        np.savez(self.cache_path, **self._cache)


class HashTextEncoder(TextEncoder):
    """Deterministic pseudo-embedding from a text hash (offline fallback for
    smoke tests; NOT a semantic encoder)."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def encode(self, text: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha1(text.strip().lower().encode()).digest()[:4], "little"
        )
        rng = np.random.RandomState(seed)
        v = rng.randn(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)


def build_text_encoder(clip_model: str = "ViT-B/16",
                       cache_path: Optional[str] = None) -> TextEncoder:
    try:
        return ClipTextEncoder(clip_model)
    except Exception as e:
        if cache_path and os.path.exists(cache_path):
            log.info(f"CLIP unavailable ({e}); using embedding cache {cache_path}")
            return CachedTextEncoder(cache_path)
        log.warning(f"CLIP unavailable ({e}); using hash text encoder "
                    "(fine for smoke tests, not for real eval)")
        return HashTextEncoder()


def build_clip_model(clip_model: str = "ViT-B/16"):
    """Reference-signature shim (`rlbench_utils.py:119-125`)."""
    enc = ClipTextEncoder(clip_model)
    return enc.model, enc.device


# ---------------------------------------------------------------------------
# Observation conversion (eval-time; dataset-pipeline reuse)
# ---------------------------------------------------------------------------

def _obs_attr(obs, name):
    return getattr(obs, name) if hasattr(obs, name) else obs[name]


def get_qpos_data(obs_list, task_name: str, collision: bool = False,
                  rot_type: str = "6d") -> np.ndarray:
    """(T, 10|11) normalized qpos rows (`rlbench_utils.py:127-153`)."""
    assert rot_type == "6d"
    rows = []
    for obs in obs_list:
        parts = [np.asarray(_obs_attr(obs, "gripper_pose"), np.float32),
                 np.asarray([_obs_attr(obs, "gripper_open")], np.float32)]
        if collision:
            parts.append(
                np.asarray([_obs_attr(obs, "ignore_collisions")], np.float32)
            )
        rows.append(np.concatenate(parts))
    qpos = np.stack(rows)
    pos_min, pos_max = (np.asarray(b, np.float32) for b in loc_bounds[task_name])
    qpos[:, :3] = (qpos[:, :3] - pos_min) / (pos_max - pos_min) * 2.0 - 1.0
    qpos[:, 3:7] = _normalize_rows(qpos[:, 3:7])
    rot = quat_to_6d_np(qpos[:, 3:7])
    return np.concatenate([qpos[:, :3], rot, qpos[:, 7:]], -1).astype(np.float32)


def get_pcd(obs_list, cameras: Sequence[str], transform_pcd, use_mask=False,
            n_obs_steps: int = 1,
            invalid_mask_values: Sequence[int] = DEFAULT_INVALID_MASK_VALUES,
            pad_multiple: int = 512) -> dict:
    """Merged/cropped/padded clouds for the first ``n_obs_steps`` observations
    (`rlbench_utils.py:155-233`), emitted in the padded collate layout."""
    compose = (transform_pcd if isinstance(transform_pcd, ComposePCD)
               else ComposePCD(transform_pcd))
    pcds = []
    for step in range(n_obs_steps):
        obs = obs_list[step]
        colors = np.concatenate([
            np.asarray(_obs_attr(obs, f"{cam}_rgb"), np.float32).reshape(-1, 3)
            for cam in cameras
        ])
        coords = np.concatenate([
            np.asarray(_obs_attr(obs, f"{cam}_point_cloud"), np.float32)
            .reshape(-1, 3) for cam in cameras
        ])
        keep = (
            (coords[:, 0] > SCENE_BOUNDS[0]) & (coords[:, 0] < SCENE_BOUNDS[3])
            & (coords[:, 1] > SCENE_BOUNDS[1]) & (coords[:, 1] < SCENE_BOUNDS[4])
            & (coords[:, 2] > SCENE_BOUNDS[2]) & (coords[:, 2] < SCENE_BOUNDS[5])
        )
        coords, colors = coords[keep], colors[keep]
        if use_mask:
            masks = np.concatenate([
                np.asarray(_obs_attr(obs, f"{cam}_mask"), np.float32).reshape(-1)
                for cam in cameras
            ])[keep]
            for v in invalid_mask_values:
                masks[masks == v] = 0
            masks = (masks > 0).astype(np.float32)
            pcd = compose(dict(
                coord=coords,
                color=np.concatenate([colors, masks[:, None]], -1),
            ), mode="test")
            pcd["mask"] = pcd["feat"][:, -1].astype(bool)
            pcd["feat"] = pcd["feat"][:, :-1]
        else:
            pcd = compose(dict(coord=coords, color=colors), mode="test")
        pcds.append(pcd)
    return pad_point_clouds(pcds, pad_multiple=pad_multiple)


def get_image_data(obs, cameras: Sequence[str], include_depth: bool = False):
    """(ncam, H, W, C) NHWC eval image (`test_rlbench_act.py:44-69`)."""
    images = []
    for cam in cameras:
        img = np.asarray(_obs_attr(obs, f"{cam}_rgb"), np.float32) / 255.0
        if include_depth:
            depth = np.asarray(
                _obs_attr(obs, f"{cam}_depth"), np.float32
            )[..., None]
            img = np.concatenate([img, depth], -1)
        images.append(img)
    return np.stack(images)


def unnormalize_position(action: np.ndarray, task_name: str) -> np.ndarray:
    pos_min, pos_max = (np.asarray(b, np.float32) for b in loc_bounds[task_name])
    action = np.asarray(action).copy()
    action[..., :3] = (action[..., :3] + 1) / 2 * (pos_max - pos_min) + pos_min
    return action


# ---------------------------------------------------------------------------
# Simulator construction (lazy RLBench/PyRep imports)
# ---------------------------------------------------------------------------

def task_file_to_task_class(task_file: str):
    import importlib

    name = task_file.replace(".py", "")
    class_name = "".join(w[0].upper() + w[1:] for w in name.split("_"))
    mod = importlib.import_module(f"rlbench.tasks.{name}")
    mod = importlib.reload(mod)
    return getattr(mod, class_name)


def _rotation_matrix(theta_deg: float, axis: str) -> np.ndarray:
    t = np.radians(theta_deg)
    c, s = np.cos(t), np.sin(t)
    m = np.eye(4)
    i, j = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis != "y" else s
    m[j, i] = s if axis != "y" else -s
    return m


def perturb_camera_matrix(matrix: np.ndarray, rot_angle: float, rot_axis: str,
                          transl: Sequence[float]) -> np.ndarray:
    """Camera-view generalization sweep transform
    (`rlbench_utils.py:252-287,305-317`)."""
    out = _rotation_matrix(rot_angle, rot_axis) @ np.asarray(matrix)
    trans = np.eye(4)
    trans[:3, 3] = transl
    return trans @ out


def build_env_and_task(cfg):
    """CoppeliaSim env + task (`rlbench_utils.py:290-326`); requires the
    RLBench/PyRep stack on the host."""
    from rlbench.action_modes.action_mode import MoveArmThenGripper
    from rlbench.action_modes.arm_action_modes import EndEffectorPoseViaPlanning
    from rlbench.action_modes.gripper_action_modes import Discrete
    from rlbench.environment import Environment
    from rlbench.observation_config import ObservationConfig

    assert not cfg.live_demos, "Live demos are not supported in this script."
    env = Environment(
        action_mode=MoveArmThenGripper(
            arm_action_mode=EndEffectorPoseViaPlanning(),
            gripper_action_mode=Discrete(),
        ),
        dataset_root=cfg.data_root,
        obs_config=ObservationConfig(),
        headless=cfg.headless,
    )
    env.launch()

    cam_test = cfg.get("camera_view_test")
    if cam_test and cam_test.get("apply"):
        cam = env._scene._cam_front
        cam.set_matrix(perturb_camera_matrix(
            cam.get_matrix(), cam_test["rot_angle"], cam_test["rot_axis"],
            cam_test["transl"],
        ))

    task = env.get_task(task_file_to_task_class(cfg.rlbench_task))
    return env, task


def reset_task(task, cfg, from_episode_number: int):
    """Replay-demo reset (`rlbench_utils.py:329-353`)."""
    var_path = os.path.join(
        cfg.data_root, cfg.rlbench_task, "all_variations", "episodes",
        f"episode{from_episode_number}", "variation_number.pkl",
    )
    with open(var_path, "rb") as f:
        var_num = pickle.load(f)
    task.set_variation(-1)
    demos = task.get_demos(
        1, random_selection=False, live_demos=cfg.live_demos,
        from_episode_number=from_episode_number,
    )
    task.set_variation(var_num)
    description, obs = task.reset_to_demo(demos[0])
    return task, demos, description, obs
