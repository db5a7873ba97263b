#!/usr/bin/env python3
"""A stand-in for the ``rlbench`` package (RLBench, PyRep and CoppeliaSim are
not installed on the machines that run the tests and ``chip_smoke.py``),
for the preprocessing script and the closed-loop evaluation. It imports
numpy, and the port's RLBench constants where it makes a cloud or a pose;
nothing of JAX::

    from tools import fake_rlbench
    fake_rlbench.write_raw(raw_root, ("close_jar",), {"train": 3, "val": 2})
    with fake_rlbench.installed(side=16, frames=8):
        preprocess_rlbench.main([...])   # imports rlbench.* as usual

:func:`installed` puts a finder first on ``sys.meta_path`` that serves
``rlbench``, ``rlbench.environment``, ``rlbench.observation_config``,
``rlbench.action_modes.{action_mode,arm_action_modes,gripper_action_modes}``
and ``rlbench.tasks.<task>`` (a class named as RLBench names it, so that
``task_file_to_task_class``'s ``importlib.reload`` finds it too). On leaving,
the finder and every ``rlbench`` module go.

The raw layout is RLBench's: ``<root>/<stage>/<task>/all_variations/
episodes/episode<i>/variation_number.pkl`` and ``variation_descriptions.pkl``
(:func:`write_raw`). ``Environment(dataset_root=<root>/<stage>)`` hands out
a task whose ``get_demos(1, from_episode_number=i)`` replays episode i:
``frames`` observations made with numpy from a seed of (stage, task, i) and
the attribute's name, so two runs see the same frames. An observation has
every attribute of the preprocessing script's defaults: each camera's
``rgb`` (uint8), ``depth``, ``mask`` and ``point_cloud`` (uniform in the
port's ``SCENE_BOUNDS`` but for ``n_outside`` points of its first row past
the upper bounds), the joints' velocities, positions and forces,
``task_low_dim_state``, the gripper's open flag, pose (inside the task's
``loc_bounds``, a unit quaternion), matrix, joint positions and touch
forces, and ``ignore_collisions``. ``reset_to_demo`` returns the episode's
stored descriptions and its first frame; ``step`` the next frame, reward 1
at step ``success_at`` of each episode (never with None).

The front camera is ``env._scene._cam_front``; every matrix set on it is
kept in ``RECORD["camera_matrices"]`` (``rlbench_utils.build_env_and_task``
perturbs it under ``camera_view_test``), every environment in
``RECORD["environments"]``.
"""

from __future__ import annotations

import contextlib
import importlib.abc
import importlib.util
import os
import pickle
import sys
import zlib
from typing import Optional

import numpy as np

CAMERAS = ("front", "left_shoulder", "right_shoulder", "wrist", "overhead")
FRONT_MATRIX = np.array([[0.0, 0.0, -1.0, 1.5], [1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 1.6],
                         [0.0, 0.0, 0.0, 1.0]])
RECORD: dict = {"camera_matrices": [], "environments": []}
CONFIG: dict = {"side": 16, "frames": 8, "n_outside": 2, "success_at": None}


def description(task_name: str, variation: int) -> str:
    """The first stored description of a task's variation."""
    return f"{task_name.replace('_', ' ')} variation {variation}"


def write_raw(root: str, task_names=("close_jar",), episodes: Optional[dict] = None,
              variations: int = 3) -> str:
    """The raw episodes' variation files under ``root`` (RLBench's layout),
    episode i of each stage in variation i % ``variations``, two stored
    descriptions each; ``episodes`` is {stage: count} (the preprocessing
    script's 100 and 25 by default). Returns ``root``."""
    for stage, count in (episodes or {"train": 100, "val": 25}).items():
        for task in task_names:
            for ep in range(count):
                ep_dir = os.path.join(root, stage, task, "all_variations", "episodes",
                                      f"episode{ep}")
                os.makedirs(ep_dir, exist_ok=True)
                var = ep % variations
                with open(os.path.join(ep_dir, "variation_number.pkl"), "wb") as f:
                    pickle.dump(var, f)
                with open(os.path.join(ep_dir, "variation_descriptions.pkl"), "wb") as f:
                    pickle.dump([description(task, var), f"{task} ({var})"], f)
    return root


def _bounds():
    """The port's scene bounds and per-task gripper bounds (imported here,
    so that the module itself needs numpy alone)."""
    from pointcloudmatters_tpu_torch.data.components.rlbench.constants import (
        SCENE_BOUNDS,
        loc_bounds,
    )

    return SCENE_BOUNDS, loc_bounds


class Observation:
    """One frame; each attribute made on first reading from a seed of the
    frame's and the attribute's names."""

    def __init__(self, key: str, task_name: str):
        self._key, self._task = key, task_name

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        value = self._make(name, np.random.RandomState(zlib.crc32(f"{self._key}/{name}"
                                                                   .encode())))
        setattr(self, name, value)
        return value

    def _make(self, name: str, rng: np.random.RandomState):
        side = CONFIG["side"]
        camera = next((c for c in CAMERAS if name.startswith(c + "_")), None)
        if camera is not None:
            modality = name[len(camera) + 1:]
            if modality == "rgb":
                return rng.randint(0, 255, (side, side, 3)).astype(np.uint8)
            if modality == "depth":
                return rng.rand(side, side).astype(np.float32)
            if modality == "mask":
                return rng.randint(0, 250, (side, side)).astype(np.float32)
            if modality == "point_cloud":
                scene, _ = _bounds()
                lo, hi = np.array(scene[:3]), np.array(scene[3:])
                cloud = rng.uniform(lo, hi, (side, side, 3)).astype(np.float32)
                cloud[0, :CONFIG["n_outside"]] = hi + 1.0
                return cloud
        if name in ("joint_velocities", "joint_positions", "joint_forces"):
            return rng.randn(7).astype(np.float32)
        if name == "task_low_dim_state":
            return rng.randn(10).astype(np.float32)
        if name in ("gripper_open", "ignore_collisions"):
            return float(rng.rand() > 0.5)
        if name == "gripper_pose":
            _, loc = _bounds()
            quat = rng.randn(4)
            return np.concatenate([rng.uniform(*loc[self._task]),
                                   quat / np.linalg.norm(quat)]).astype(np.float32)
        if name == "gripper_matrix":
            return rng.randn(4, 4).astype(np.float32)
        if name == "gripper_joint_positions":
            return rng.rand(2).astype(np.float32)
        if name == "gripper_touch_forces":
            return rng.randn(6).astype(np.float32)
        raise AttributeError(f"a fake RLBench observation has no {name!r}")


class Demo(list):
    """An episode's observations, with its stored descriptions."""

    descriptions: list


class Camera:
    def __init__(self):
        self.matrix = FRONT_MATRIX.copy()

    def get_matrix(self) -> np.ndarray:
        return self.matrix.copy()

    def set_matrix(self, matrix) -> None:
        self.matrix = np.asarray(matrix, np.float64)
        RECORD["camera_matrices"].append(self.matrix.copy())


class Scene:
    def __init__(self):
        self._cam_front = Camera()


class Task:
    """The base of the ``rlbench.tasks`` classes."""


class TaskEnvironment:
    def __init__(self, env: "Environment", task_class):
        self.env, self.task_class = env, task_class
        self.task_name = task_class.task_name
        self.variation = None
        self.demo: Optional[Demo] = None

    def set_variation(self, variation: int) -> None:
        self.variation = variation

    def get_demos(self, amount: int, random_selection: bool = True, live_demos: bool = False,
                  from_episode_number: int = 0) -> list:
        if live_demos or random_selection or amount != 1:
            raise NotImplementedError("the fake replays one stored demo by its number")
        root = self.env.dataset_root
        ep_dir = os.path.join(root, self.task_name, "all_variations", "episodes",
                              f"episode{from_episode_number}")
        with open(os.path.join(ep_dir, "variation_descriptions.pkl"), "rb") as f:
            descriptions = pickle.load(f)
        key = f"{os.path.basename(os.path.normpath(root))}/{self.task_name}/" \
              f"{from_episode_number}"
        demo = Demo(Observation(f"{key}/{t}", self.task_name) for t in range(CONFIG["frames"]))
        demo.descriptions = descriptions
        return [demo]

    def reset_to_demo(self, demo: Demo):
        self.demo, self.t = demo, 0
        return list(demo.descriptions), demo[0]

    def step(self, action):
        self.t += 1
        done = CONFIG["success_at"] is not None and self.t == CONFIG["success_at"]
        return self.demo[self.t % len(self.demo)], float(done), False


class Environment:
    def __init__(self, action_mode=None, dataset_root: str = "", obs_config=None,
                 headless: bool = True, **kwargs):
        self.action_mode, self.dataset_root = action_mode, dataset_root
        self.obs_config, self.headless = obs_config, headless
        self._scene = Scene()
        self.launched = self.shut = False
        RECORD["environments"].append(self)

    def launch(self) -> None:
        self.launched = True

    def get_task(self, task_class) -> TaskEnvironment:
        return TaskEnvironment(self, task_class)

    def shutdown(self) -> None:
        self.shut = True


class ObservationConfig:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


class _Mode:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


class MoveArmThenGripper(_Mode):
    pass


class EndEffectorPoseViaPlanning(_Mode):
    pass


class Discrete(_Mode):
    pass


def _task_class(task_name: str):
    name = "".join(w[0].upper() + w[1:] for w in task_name.split("_"))
    return type(name, (Task,), {"task_name": task_name})


MODULES = {
    "rlbench": {}, "rlbench.action_modes": {}, "rlbench.tasks": {},
    "rlbench.environment": {"Environment": Environment},
    "rlbench.observation_config": {"ObservationConfig": ObservationConfig},
    "rlbench.action_modes.action_mode": {"MoveArmThenGripper": MoveArmThenGripper},
    "rlbench.action_modes.arm_action_modes": {
        "EndEffectorPoseViaPlanning": EndEffectorPoseViaPlanning},
    "rlbench.action_modes.gripper_action_modes": {"Discrete": Discrete},
}
PACKAGES = ("rlbench", "rlbench.action_modes", "rlbench.tasks")


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves the fake's modules, and ``rlbench.tasks.<task>`` for any task."""

    def find_spec(self, name, path=None, target=None):
        if name in MODULES or name.startswith("rlbench.tasks."):
            return importlib.util.spec_from_loader(name, self, is_package=name in PACKAGES)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module) -> None:
        name = module.__name__
        if name.startswith("rlbench.tasks."):
            task = name.rpartition(".")[2]
            cls = _task_class(task)
            setattr(module, cls.__name__, cls)
        for attr, value in MODULES.get(name, {}).items():
            setattr(module, attr, value)


@contextlib.contextmanager
def installed(**config):
    """The fake ``rlbench`` importable inside (``config`` sets CONFIG's
    ``side``, ``frames``, ``n_outside``, ``success_at``); RECORD cleared on
    entry."""
    unknown = set(config) - set(CONFIG)
    if unknown:
        raise TypeError(f"unknown settings {sorted(unknown)}")
    saved = dict(CONFIG)
    CONFIG.update(config)
    for v in RECORD.values():
        v.clear()
    finder = _Finder()
    sys.meta_path.insert(0, finder)
    try:
        yield sys.modules[__name__]
    finally:
        sys.meta_path.remove(finder)
        for name in [m for m in sys.modules if m == "rlbench" or m.startswith("rlbench.")]:
            del sys.modules[name]
        CONFIG.clear()
        CONFIG.update(saved)
