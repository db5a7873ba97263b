"""Custom ManiSkill2 env variants, the generalization sweeps' registrations
(port of ``pointcloudmatters_tpu/envs/custom_maniskill2/__init__.py``).

The reference defines ~54 env re-registrations as hand-written subclasses
(`src/envs/custom_maniskill2/`, ~5,000 LoC): MultiView camera rigs,
ambient-light sweeps, background/foreground color sweeps, stereo-depth
noise, and the staged PegInsertionSide-3steps evaluator. All of them are
mechanical variants of the installed ManiSkill2 task classes, so this module
builds the same env-ID surface at import: factory functions build each
variant's subclass and register it.

Everything here is simulator-side (SAPIEN on the host). Without
``mani_skill2`` the import registers nothing, so training never depends on
the simulator.
"""

from __future__ import annotations

import numpy as np

from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

# env-ID surface (reference registrations, `pick_and_place/stack_cube.py:62,
# 226-330`, `misc/turn_faucet.py`, `mpm/*.py`)
LIGHT_LEVELS = {
    "StackCube": ["base", 0.03, 0.0375, 0.05, 0.075, 0.15, 0.6, 1.2, 1.8, 2.4, 3],
    "TurnFaucet": ["base", 0.03, 0.05, 0.15, 0.6, 1.8, 3.0],
    "Hang": ["base", 0.03, 0.05, 0.15, 0.6, 1.8, 3.0],
}
BACKGROUND_LEVELS = ["base"] + [
    f"{color}-{level}" for color in ("red", "green")
    for level in (0.2, 0.4, 0.6, 0.8, 1.0)
]
FOREGROUND_LEVELS = ["base"] + [f"redcube-{v}" for v in (0.2, 0.4, 0.6, 0.8)]
MULTIVIEW_TASKS = [
    "PickCube", "LiftCube", "StackCube", "TurnFaucet",
    "PegInsertionSide-3steps", "Hang", "Pour", "Fill", "Excavate",
]
DEPTH_NOISE_STDS = [0.01, 0.05]
MULTIVIEW_ANGLES = [5, 10, 30]

_registered = False


def iter_env_ids() -> list[str]:
    """The full custom env-ID surface this module registers, computed without
    importing ManiSkill2 — the sweep scripts are tested against this list
    (tests/test_env_registry.py), so script<->registry drift fails CI."""
    ids = ["PegInsertionSide-3steps-v0"]
    ids += [f"{task}-MultiView" for task in MULTIVIEW_TASKS]
    for task, levels in LIGHT_LEVELS.items():
        ids += [f"{task}-light-{level}" for level in levels]
    ids += [f"StackCube-background-{level}" for level in BACKGROUND_LEVELS]
    ids += [f"StackCube-foreground-{level}" for level in FOREGROUND_LEVELS]
    ids += [f"Hang-depth-noise-std{std}" for std in DEPTH_NOISE_STDS]
    return ids


def _camera_cfg(CameraConfig, look_at, name, eye, target=(-0.1, 0, 0.1)):
    pose = look_at(list(eye), list(target))
    return CameraConfig(name, pose.p, pose.q, 128, 128, np.pi / 2, 0.01, 10)


def make_multiview_cameras(CameraConfig, look_at):
    """4 base cams + left/down ring at 5/10/30 degrees, 128^2, fov pi/2
    (`pick_and_place/base_env.py:119-188`)."""
    cams = [
        _camera_cfg(CameraConfig, look_at, "front_camera", (0.3, 0, 0.6)),
        _camera_cfg(CameraConfig, look_at, "back_camera", (-0.5, 0.2, 0.6)),
        _camera_cfg(CameraConfig, look_at, "right_camera", (0, 0.3, 0.6)),
        _camera_cfg(CameraConfig, look_at, "left_camera", (0, -0.3, 0.6)),
    ]
    r = 0.3
    for angle in MULTIVIEW_ANGLES:
        a = np.radians(angle)
        cams.append(_camera_cfg(
            CameraConfig, look_at, f"left_camera_{angle}",
            (r * np.cos(-a), r * np.sin(-a), 0.6),
        ))
        cams.append(_camera_cfg(
            CameraConfig, look_at, f"down_camera_{angle}",
            (r * np.cos(-a), 0, 0.6 + r * np.sin(-a)),
        ))
    return cams


def _euler0bc_quat(b, c):
    """wxyz quaternion for transforms3d ``euler2quat(0, b, c)`` (sxyz:
    R = Rz(c) @ Ry(b)) without the transforms3d dependency."""
    try:
        from transforms3d.euler import euler2quat

        return list(euler2quat(0, b, c))
    except ImportError:
        cb, sb = np.cos(b / 2), np.sin(b / 2)
        cc, sc = np.cos(c / 2), np.sin(c / 2)
        return [cb * cc, -sb * sc, sb * cc, cb * sc]


# Per-task soft-body (MPM) MultiView rigs — each task defines its OWN rig in
# the reference; parameters transcribed from `mpm/{hang,pour,fill,excavate}
# _env.py::_register_cameras`:
#   front: fixed pose (p, euler2quat(0, pitch, yaw))
#   back/right/left: look_at(eye, (-0.1, 0, 0.1)), 128^2, fov pi/2
#   rings: left_camera_A at (r cos(-a), r sin(-a), ring_z) per angle A,
#     down_camera_A at (r cos(-a), 0, ring_z + down_sign * r sin(-a));
#     only Hang adds the right_camera_A / up_camera_A mirrors.
#   max_episode_steps: Hang/Pour 350, Fill/Excavate 250.
MPM_RIGS = {
    # hang_env.py:174-266 / :20 (350 steps)
    "Hang": dict(
        front_p=(0.45, 0.0, 0.5), front_euler=(np.pi / 5, np.pi),
        back=(-0.45, 0.1, 0.6), right=(0, 0.45, 0.6), left=(0, -0.45, 0.6),
        r=0.45, ring_z=0.5, angles=(5, 10, 30), down_sign=+1.0,
        with_right_up=True, max_steps=350,
    ),
    # pour_env.py:236-296 / :84 (350 steps) — 5/10-degree rings only
    "Pour": dict(
        front_p=(0.4, 0.0, 0.3), front_euler=(np.pi / 10, -np.pi),
        back=(-0.4, 0.1, 0.3), right=(0, 0.4, 0.3), left=(0.1, -0.4, 0.3),
        r=0.4, ring_z=0.3, angles=(5, 10), down_sign=+1.0,
        with_right_up=False, max_steps=350,
    ),
    # fill_env.py:130-190 / :43 (250 steps) — negative radius, z 0.4,
    # down cameras at ring_z - r*sin(-a)
    "Fill": dict(
        front_p=(-0.4, 0.0, 0.4), front_euler=(np.pi / 6, 0.0),
        back=(0.2, -0.1, 0.4), right=(0, 0.2, 0.4), left=(0, -0.2, 0.4),
        r=-0.4, ring_z=0.4, angles=(5, 10, 30), down_sign=-1.0,
        with_right_up=False, max_steps=250,
    ),
    # excavate_env.py:148-213 / :16 (250 steps)
    "Excavate": dict(
        front_p=(-0.2, 0.0, 0.4), front_euler=(np.pi / 6, 0.0),
        back=(0.2, -0.1, 0.4), right=(0, 0.2, 0.4), left=(0, -0.2, 0.4),
        r=-0.2, ring_z=0.4, angles=(5, 10), down_sign=-1.0,
        with_right_up=False, max_steps=250,
    ),
}


def make_softbody_multiview_cameras(task, CameraConfig, look_at):
    """Per-task MPM MultiView rig (see ``MPM_RIGS``)."""
    rig = MPM_RIGS[task]
    front_q = _euler0bc_quat(*rig["front_euler"])
    cams = [
        CameraConfig("front_camera", list(rig["front_p"]), list(front_q),
                     128, 128, np.pi / 2, 0.01, 10),
        _camera_cfg(CameraConfig, look_at, "back_camera", rig["back"]),
        _camera_cfg(CameraConfig, look_at, "right_camera", rig["right"]),
        _camera_cfg(CameraConfig, look_at, "left_camera", rig["left"]),
    ]
    r, z = rig["r"], rig["ring_z"]
    for angle in rig["angles"]:
        a = np.radians(angle)
        cams.append(_camera_cfg(
            CameraConfig, look_at, f"left_camera_{angle}",
            (r * np.cos(-a), r * np.sin(-a), z),
        ))
        if rig["with_right_up"]:
            cams.append(_camera_cfg(
                CameraConfig, look_at, f"right_camera_{angle}",
                (r * np.cos(a), r * np.sin(a), z),
            ))
    for angle in rig["angles"]:
        a = np.radians(angle)
        if rig["with_right_up"]:
            cams.append(_camera_cfg(
                CameraConfig, look_at, f"up_camera_{angle}",
                (r * np.cos(a), 0, z + r * np.sin(a)),
            ))
        cams.append(_camera_cfg(
            CameraConfig, look_at, f"down_camera_{angle}",
            (r * np.cos(-a), 0, z + rig["down_sign"] * r * np.sin(-a)),
        ))
    return cams


def register_custom_envs() -> bool:
    """Build + register every variant. Returns False when ManiSkill2 is not
    installed (silent no-op)."""
    global _registered
    if _registered:
        return True
    try:
        from mani_skill2.sensors.camera import CameraConfig
        from mani_skill2.utils.registration import register_env
        from mani_skill2.utils.sapien_utils import look_at
        import mani_skill2.envs.pick_and_place.pick_cube as pc
        import mani_skill2.envs.pick_and_place.stack_cube as sc
        import mani_skill2.envs.assembly.peg_insertion_side as peg
        import mani_skill2.envs.misc.turn_faucet as tf
    except ImportError as e:
        log.info(f"mani_skill2 unavailable; custom envs not registered ({e})")
        return False

    registered_ids: list[str] = []

    def _register(uid: str, max_episode_steps: int):
        registered_ids.append(uid)
        return register_env(uid, max_episode_steps=max_episode_steps,
                            override=True)

    base_classes = {
        "PickCube": pc.PickCubeEnv,
        "LiftCube": pc.LiftCubeEnv,
        "StackCube": sc.StackCubeEnv,
        "PegInsertionSide": peg.PegInsertionSideEnv,
        "TurnFaucet": tf.TurnFaucetEnv,
    }
    try:  # soft-body (warp) tasks are an optional ManiSkill2 extra
        import mani_skill2.envs.mpm.hang_env as hang
        import mani_skill2.envs.mpm.pour_env as pour
        import mani_skill2.envs.mpm.fill_env as fill
        import mani_skill2.envs.mpm.excavate_env as exc

        base_classes.update({
            "Hang": hang.HangEnv, "Pour": pour.PourEnv,
            "Fill": fill.FillEnv, "Excavate": exc.ExcavateEnv,
        })
    except ImportError:
        log.info("ManiSkill2 soft-body (warp) tasks unavailable; skipping")

    def base_camera_cfg(self):
        return _camera_cfg(CameraConfig, look_at, "base_camera", (0.3, 0, 0.6))

    # --- staged PegInsertionSide evaluator (`assembly/peg_insertion_side.py:179-199`)
    def staged_evaluate(self, **kwargs):
        info = base_classes["PegInsertionSide"].evaluate(self, **kwargs)
        is_grasped = self.agent.check_grasp(self.peg, max_angle=20)
        pre_inserted = False
        if is_grasped:
            peg_head_wrt_goal = self.goal_pose.inv() * self.peg_head_pose
            peg_wrt_goal = self.goal_pose.inv() * self.peg.pose
            if (np.linalg.norm(peg_head_wrt_goal.p[1:]) < 0.01
                    and np.linalg.norm(peg_wrt_goal.p[1:]) < 0.01):
                pre_inserted = True
        info.update(is_grasped=is_grasped, pre_inserted=pre_inserted)
        return info

    peg3 = type("PegInsertionSide3StepsEnv",
                (base_classes["PegInsertionSide"],),
                {"evaluate": staged_evaluate,
                 "_register_cameras": base_camera_cfg})
    _register("PegInsertionSide-3steps-v0", 200)(peg3)
    base_classes["PegInsertionSide-3steps"] = peg3

    # --- MultiView rigs. Rigid tasks share one rig (200 steps); each
    # soft-body task has its own reference-defined rig + step budget
    # (``MPM_RIGS``: Hang/Pour 350 steps, Fill/Excavate 250).
    SOFTBODY_TASKS = {"Hang", "Pour", "Fill", "Excavate"}
    for task in MULTIVIEW_TASKS:
        base = base_classes.get(task)
        if base is None:
            continue
        if task in SOFTBODY_TASKS:
            rig = lambda CC, la, task=task: make_softbody_multiview_cameras(
                task, CC, la
            )
            max_steps = MPM_RIGS[task]["max_steps"]
        else:
            rig = make_multiview_cameras
            max_steps = 200
        cls = type(f"{task.replace('-', '')}MultiViewEnv", (base,), {
            "_register_cameras":
                lambda self, rig=rig: rig(CameraConfig, look_at),
        })
        _register(f"{task}-MultiView", max_steps)(cls)

    # --- ambient-light sweeps (`stack_cube.py:226-305`)
    def make_light_cls(base, intensity):
        def _setup_lighting(self):
            if getattr(self, "bg_name", None) is not None:
                return
            shadow = self.enable_shadow
            self._scene.set_ambient_light([intensity] * 3)
            self._scene.add_directional_light(
                [1, 1, -1], [1, 1, 1], shadow=shadow, scale=5,
                shadow_map_size=2048,
            )
            self._scene.add_directional_light([0, 0, -1], [1, 1, 1])

        attrs = {"_register_cameras": base_camera_cfg}
        if intensity != "base":
            attrs["_setup_lighting"] = _setup_lighting
        return type(f"{base.__name__}Light", (base,), attrs)

    for task, levels in LIGHT_LEVELS.items():
        base = base_classes.get(task)
        if base is None:
            continue
        for level in levels:
            _register(f"{task}-light-{level}", 200)(make_light_cls(base, level))

    # --- background color sweeps (StackCube, `stack_cube.py:308-...`)
    def make_background_cls(base, color, strength):
        def _setup_lighting(self):
            rgb = ([strength, 0, 0] if color == "red" else [0, strength, 0])
            self._scene.set_ambient_light(rgb)
            self._scene.add_directional_light(
                [1, 1, -1], rgb, shadow=self.enable_shadow, scale=5,
                shadow_map_size=2048,
            )
            self._scene.add_directional_light([0, 0, -1], rgb)

        attrs = {"_register_cameras": base_camera_cfg}
        if color is not None:
            attrs["_setup_lighting"] = _setup_lighting
        return type(f"{base.__name__}Background", (base,), attrs)

    sc_base = base_classes["StackCube"]
    for level in BACKGROUND_LEVELS:
        if level == "base":
            cls = make_background_cls(sc_base, None, None)
        else:
            color, strength = level.split("-")
            cls = make_background_cls(sc_base, color, float(strength))
        _register(f"StackCube-background-{level}", 200)(cls)

    # --- foreground cube-color sweeps
    def make_foreground_cls(base, red_level):
        def _load_actors(self):
            self._add_ground(render=self.bg_name is None)
            self.box_half_size = np.float32([0.02] * 3)
            red = (red_level, 0, 0) if red_level is not None else (1, 0, 0)
            self.cubeA = self._build_cube(self.box_half_size, color=red,
                                          name="cubeA")
            self.cubeB = self._build_cube(self.box_half_size, color=(0, 1, 0),
                                          name="cubeB", static=False)

        attrs = {"_register_cameras": base_camera_cfg}
        if red_level is not None:
            attrs["_load_actors"] = _load_actors
        return type(f"{base.__name__}Foreground", (base,), attrs)

    for level in FOREGROUND_LEVELS:
        red = None if level == "base" else float(level.split("-")[1])
        _register(f"StackCube-foreground-{level}", 200)(make_foreground_cls(sc_base, red))

    # --- stereo-depth noise variants (Hang)
    if "Hang" in base_classes:
        def make_noise_cls(base, std):
            def get_obs(self):
                obs = base.get_obs(self)
                if isinstance(obs, dict) and "pointcloud" in obs:
                    xyzw = obs["pointcloud"]["xyzw"]
                    noise = np.random.normal(0, std, xyzw[..., :3].shape)
                    obs["pointcloud"]["xyzw"][..., :3] = xyzw[..., :3] + noise
                return obs

            return type(f"{base.__name__}Noise", (base,),
                        {"get_obs": get_obs,
                         "_register_cameras": base_camera_cfg})

        for std in DEPTH_NOISE_STDS:
            _register(f"Hang-depth-noise-std{std}", 200)(make_noise_cls(base_classes["Hang"], std))

    # registration <-> generator consistency: the sweep scripts are tested
    # against iter_env_ids(), so the actual register_env calls must produce
    # exactly that surface (minus soft-body tasks when warp is unavailable)
    # The same invariant is enforced as a hard failure in CI
    # (tests/test_env_registry.py); at import time on simulator hosts we
    # only log, so a drift never crashes training entrypoints that don't
    # touch the drifted id.
    expected = set(iter_env_ids())
    got = set(registered_ids)
    unexpected = got - expected
    if unexpected:
        log.error(
            "register_custom_envs produced ids iter_env_ids() does not "
            f"declare (update iter_env_ids): {sorted(unexpected)}"
        )
    softbody = ("Hang", "Pour", "Fill", "Excavate")
    missing = {
        uid for uid in expected - got
        if not any(t in uid for t in softbody)
    }
    if missing:
        log.error(
            "iter_env_ids() declares ids register_custom_envs never "
            f"registered: {sorted(missing)}"
        )

    _registered = True
    log.info(
        f"registered {len(registered_ids)} custom ManiSkill2 env variants"
    )
    return True


register_custom_envs()
