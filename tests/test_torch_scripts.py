"""The port's copies of the reference's scripts, on the CPU: the three
generalization sweeps under ``pointcloudmatters_tpu_torch/scripts/`` and
``python -m pointcloudmatters_tpu_torch.preprocess_rlbench``.

- A twin of ``tests/test_env_registry.py`` against the port: every env id a
  sweep script emits is one the port's ``iter_env_ids()`` produces (or one
  of ManiSkill2's own), the ray-tracing and stereo-depth knobs reach
  ``make_maniskill2_env``'s keywords, the PegInsertionSide remap, and the
  port's ``register_custom_envs`` against stubbed ManiSkill2 modules. The
  scripts run under a stubbed ``python`` that records its arguments, in
  ``tmp_path`` only (the JAX test writes its stub into the repository root,
  and another worker may run it at the same time).
- Each port script emits, command for command, the reference script's
  override lists under the stub; only the entry point differs
  (``-m pointcloudmatters_tpu_torch.validate`` / ``.test_rlbench_act``
  for ``src/validate.py`` / ``src/test_rlbench_act.py``).
- Every command each sweep emits composes with the port's composer
  (``utils/config.py``) and its overrides land where the reference's do:
  ``model.env_id``, ``data.train.camera_ids`` / ``camera_names``, the
  ray-tracing keys, ``task_name``, ``camera_view_test.*``, ``result_name``.
- ``preprocess_rlbench.main`` of both packages (the JAX script run by its
  path) against the same fake ``rlbench`` (``tools/fake_rlbench.py``) with
  ``--text-encoder hash``: every ``ep<i>.npy`` of both stages and
  ``clip_cache.npz`` equal, key for key and array for array; the episodes
  load in the port's ``RLBenchSingleTaskACTPCDDataset`` and
  ``RLBenchSingleTaskDiffusionPolicyPCDDataset`` through the configs'
  compositions.
"""

from __future__ import annotations

import os
import pathlib
import re
import runpy
import shlex
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.envs.custom_maniskill2 import iter_env_ids as jax_iter_env_ids
from pointcloudmatters_tpu_torch import preprocess_rlbench
from pointcloudmatters_tpu_torch.envs.custom_maniskill2 import iter_env_ids
from pointcloudmatters_tpu_torch.envs.rollout import maniskill2_env_kwargs
from tools import fake_rlbench

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SCRIPTS = REPO / "pointcloudmatters_tpu_torch" / "scripts"
STANDARD_IDS = {
    "PickCube-v0", "LiftCube-v0", "StackCube-v0", "PegInsertionSide-v0",
    "TurnFaucet-v0", "Hang-v0", "Pour-v0", "Fill-v0", "Excavate-v0",
}
MANISKILL2_ARGS = {
    "run_maniskill2_camera_view.sh": (["/ckpt.ckpt", "PickCube-v0", "scratch_pointnet_pcd", "0"],
                                      ["/ckpt.ckpt", "PegInsertionSide-v0",
                                       "scratch_resnet18_rgbd", "0"]),
    "run_maniskill2_visual_changes.sh": (["/ckpt.ckpt", "scratch_pointnet_pcd", "0"],),
}
RLBENCH_ARGS = {"run_rlbench_camera_view.sh": (["scratch_pointnet_pcd", "close_jar",
                                                "/ckpt.ckpt"],)}
# the commands composed: a shipped image model in place of the twin's resnet18
COMPOSED_ARGS = {**MANISKILL2_ARGS, **RLBENCH_ARGS, "run_maniskill2_camera_view.sh": (
    MANISKILL2_ARGS["run_maniskill2_camera_view.sh"][0],
    ["/ckpt.ckpt", "PegInsertionSide-v0", "scratch_resnet50_rgbd", "0"])}
ENTRY = {"src/validate.py": "-m pointcloudmatters_tpu_torch.validate",
         "src/test_rlbench_act.py": "-m pointcloudmatters_tpu_torch.test_rlbench_act"}


def recorded_commands(script: pathlib.Path, args: list[str], tmp: pathlib.Path) -> list[list]:
    """The argument lists of every ``python`` call ``script`` makes with
    ``args``, under a stub that records them (in ``tmp``)."""
    bindir = tmp / "stub_bin"
    bindir.mkdir(exist_ok=True)
    record = tmp / "record.txt"
    record.unlink(missing_ok=True)
    stub = bindir / "python"
    stub.write_text(f'#!/usr/bin/env bash\nprintf "%q " "$@" >> {record}\necho >> {record}\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    proc = subprocess.run(["bash", str(script), *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return [shlex.split(line) for line in record.read_text().splitlines()]


def _script_env_ids(script: str, tmp: pathlib.Path) -> set[str]:
    ids = set()
    for args in MANISKILL2_ARGS[script]:
        for argv in recorded_commands(PORT_SCRIPTS / script, args, tmp):
            ids.update(m.group(1) for a in argv for m in [re.fullmatch(r"model\.env_id=(\S+)",
                                                                         a)] if m)
    return ids


def test_port_iter_env_ids_equal_jax():
    assert iter_env_ids() == jax_iter_env_ids()


def test_visual_changes_script_ids_are_registered(tmp_path):
    ids = _script_env_ids("run_maniskill2_visual_changes.sh", tmp_path)
    assert ids, "script produced no env ids (parse failure?)"
    missing = ids - (set(iter_env_ids()) | STANDARD_IDS)
    assert not missing, f"sweep ids not in the registry: {sorted(missing)}"
    for light in ("0.03", "0.05", "0.15", "0.6", "1.8", "3"):
        assert f"StackCube-light-{light}" in ids
    for c in ("red", "green"):
        for v in ("0.2", "0.6", "1.0"):
            assert f"StackCube-background-{c}-{v}" in ids


def test_camera_view_script_ids_are_registered(tmp_path):
    ids = _script_env_ids("run_maniskill2_camera_view.sh", tmp_path)
    assert ids, "script produced no env ids (parse failure?)"
    missing = ids - (set(iter_env_ids()) | STANDARD_IDS)
    assert not missing, f"sweep ids not in the registry: {sorted(missing)}"
    assert "PickCube-MultiView" in ids
    assert "PegInsertionSide-3steps-MultiView" in ids


def test_rt_noise_knobs_reach_gym_make():
    env_id, kwargs = maniskill2_env_kwargs(
        "StackCube-v0", shader_dir="rt", rt_samples_per_pixel=16, rt_use_denoiser=False)
    assert env_id == "StackCube-v0"
    assert kwargs["shader_dir"] == "rt"
    assert kwargs["render_config"] == {"rt_samples_per_pixel": 16, "rt_use_denoiser": False}


def test_stereo_depth_knob_reaches_camera_cfgs():
    _, kwargs = maniskill2_env_kwargs("Hang-v0", use_stereo_depth=True)
    assert kwargs["camera_cfgs"]["use_stereo_depth"] is True
    _, kwargs = maniskill2_env_kwargs("Hang-v0", use_stereo_depth=False)
    assert "use_stereo_depth" not in kwargs["camera_cfgs"]


def test_peg_insertion_eval_remap_quirk():
    env_id, _ = maniskill2_env_kwargs("PegInsertionSide-v0")
    assert env_id == "PegInsertionSide-3steps-v0"


def test_register_custom_envs_matches_generator(monkeypatch):
    """The port's registration against stubbed ManiSkill2 modules registers
    what ``iter_env_ids()`` declares (the soft-body tasks' module absent)."""
    import pointcloudmatters_tpu_torch.envs.custom_maniskill2 as reg

    class _Pose:
        p = [0.0, 0.0, 0.0]
        q = [1.0, 0.0, 0.0, 0.0]

    class CameraConfig:
        def __init__(self, *a, **k):
            pass

    registered = {}

    def register_env(uid, max_episode_steps=None, override=False):
        def deco(cls):
            registered[uid] = (cls, max_episode_steps)
            return cls

        return deco

    def stub(name, **attrs):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        monkeypatch.setitem(sys.modules, name, mod)

    class _BaseEnv:
        enable_shadow = False

        def evaluate(self, **kw):
            return {}

    stub("mani_skill2")
    stub("mani_skill2.sensors")
    stub("mani_skill2.sensors.camera", CameraConfig=CameraConfig)
    stub("mani_skill2.utils")
    stub("mani_skill2.utils.registration", register_env=register_env)
    stub("mani_skill2.utils.sapien_utils", look_at=lambda eye, target: _Pose())
    stub("mani_skill2.envs")
    stub("mani_skill2.envs.pick_and_place")
    stub("mani_skill2.envs.pick_and_place.pick_cube",
         PickCubeEnv=type("PickCubeEnv", (_BaseEnv,), {}),
         LiftCubeEnv=type("LiftCubeEnv", (_BaseEnv,), {}))
    stub("mani_skill2.envs.pick_and_place.stack_cube",
         StackCubeEnv=type("StackCubeEnv", (_BaseEnv,), {}))
    stub("mani_skill2.envs.assembly")
    stub("mani_skill2.envs.assembly.peg_insertion_side",
         PegInsertionSideEnv=type("PegInsertionSideEnv", (_BaseEnv,), {}))
    stub("mani_skill2.envs.misc")
    stub("mani_skill2.envs.misc.turn_faucet",
         TurnFaucetEnv=type("TurnFaucetEnv", (_BaseEnv,), {}))
    monkeypatch.setattr(reg, "_registered", False)
    assert reg.register_custom_envs() is True
    got, expected = set(registered), set(iter_env_ids())
    assert got <= expected, sorted(got - expected)
    hard = {u for u in expected if not any(t in u for t in ("Hang", "Pour", "Fill", "Excavate"))}
    assert hard <= got, sorted(hard - got)
    assert registered["PegInsertionSide-3steps-v0"][1] == 200
    assert registered["StackCube-MultiView"][1] == 200
    monkeypatch.setattr(reg, "_registered", False)


# ---------------------------------------------------------------------------
# the port's scripts against the reference's, and through the composer
# ---------------------------------------------------------------------------

def _both(script: str, args: list[str], tmp: pathlib.Path) -> tuple[list, list]:
    port = recorded_commands(PORT_SCRIPTS / script, args, tmp / "port")
    ref = recorded_commands(REPO / "scripts" / script, args, tmp / "ref")
    return port, ref


@pytest.mark.parametrize("script, args", [
    (s, a) for table in (MANISKILL2_ARGS, RLBENCH_ARGS) for s, runs in table.items()
    for a in runs], ids=lambda v: v if isinstance(v, str) else "-".join(v[1:3]))
def test_port_scripts_emit_the_reference_overrides(script, args, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port, ref = _both(script, args, tmp_path)
    assert ref and len(port) == len(ref)
    for p, r in zip(port, ref):
        assert " ".join(p[:2]) == ENTRY[r[0]], (p[:2], r[0])
        assert p[2:] == r[1:]


def _composed(argv: list[str], tmp: pathlib.Path, config_name: str = "train"):
    from pointcloudmatters_tpu_torch.train import compose_run

    return compose_run(argv + ["extras.print_config=false"], output_dir=str(tmp / "run"),
                       config_name=config_name)


def _value(v):
    return [_value(x) for x in v.strip("[]").split(",")] if v.startswith("[") else (
        int(v) if v.isdigit() else {"true": True, "false": False}.get(v, v))


def test_every_sweep_command_composes_with_its_overrides(tmp_path):
    """Each emitted command composes in the port as in the JAX composer, with
    every override at its key; resolved, it equals JAX's resolution, or
    raises JAX's error where JAX's does: the point-cloud NullGoal task
    config of StackCube, which every visual-changes command names, drops
    ``data.train.chunk_size`` (ROADMAP.md §3)."""
    from pointcloudmatters_tpu.utils import config as JC
    from pointcloudmatters_tpu_torch.train import CONFIG_DIR
    from pointcloudmatters_tpu_torch.utils import config as TC

    commands = [argv for script, runs in COMPOSED_ARGS.items() for args in runs
                for argv in recorded_commands(PORT_SCRIPTS / script, args, tmp_path)]
    assert len(commands) == 4 + 4 + 16 + 8
    unresolved = set()
    for argv in commands:
        entry, overrides = argv[1], argv[2:]
        config = "test_rlbench_act" if entry.endswith("test_rlbench_act") else "train"
        ref, got = JC.compose(CONFIG_DIR, config, overrides), TC.compose(CONFIG_DIR, config,
                                                                          overrides)
        assert TC.to_container(got) == JC.to_container(ref)
        for key, value in (o.split("=", 1) for o in overrides):
            if "/" not in key and not key.startswith("exp_"):
                assert TC.select(got, key) == _value(value), (key, value)
        for engine in (JC, TC):
            engine.set_runtime(output_dir="/out", cwd="/cwd")
        try:
            JC.resolve_config(ref)
        except KeyError as err:
            with pytest.raises(KeyError) as port_err:
                TC.resolve_config(got)
            assert str(port_err.value) == str(err)
            unresolved.add(next(o for o in overrides if "_task@" in o).rsplit("=", 1)[1])
        else:
            assert TC.to_container(TC.resolve_config(got)) == JC.to_container(ref)
    assert unresolved == {"StackCube-v0"}  # the visual-changes sweep's point-cloud task


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def _preprocess(main, raw: str, out: str) -> None:
    with fake_rlbench.installed(side=16, frames=4):
        main(["--task_names", "close_jar", "--root", raw, "--save_root", out,
              "--text-encoder", "hash"])


def _jax_main(argv: list[str]) -> None:
    saved = sys.argv
    sys.argv = [str(REPO / "scripts" / "preprocess_rlbench.py"), *argv]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = saved


def _equal(a, b, where: str) -> None:
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """The raw variation files of 100 + 25 episodes, and both packages'
    processed trees of them."""
    tmp = tmp_path_factory.mktemp("rlbench")
    raw = fake_rlbench.write_raw(str(tmp / "raw"))
    _preprocess(preprocess_rlbench.main, raw, str(tmp / "port"))
    _preprocess(_jax_main, raw, str(tmp / "jax"))
    return tmp


def test_preprocessed_files_equal_the_reference_script(preprocessed):
    for stage, n in preprocess_rlbench.EPISODES.items():
        names = sorted(os.listdir(preprocessed / "jax" / stage / "close_jar"))
        assert names == sorted(f"ep{i}.npy" for i in range(n))
        assert sorted(os.listdir(preprocessed / "port" / stage / "close_jar")) == names
        for name in names:
            got, ref = (np.load(preprocessed / pkg / stage / "close_jar" / name,
                                allow_pickle=True).item() for pkg in ("port", "jax"))
            _equal(got, ref, f"{stage}/{name}")
    frame = got["demo"][0]
    assert len(got["demo"]) == 4 and got["task_goal"].shape == (512,)
    assert set(frame) == {"ignore_collisions", "front_rgb", "front_depth", "front_mask",
                          "front_point_cloud", "joint_velocities", "joint_positions",
                          "joint_forces", "task_low_dim_state", "gripper_open",
                          "gripper_pose", "gripper_matrix", "gripper_joint_positions",
                          "gripper_touch_forces"}
    got, ref = (dict(np.load(preprocessed / pkg / "clip_cache.npz")) for pkg in ("port", "jax"))
    _equal(got, ref, "clip_cache")
    assert len(got) == 3  # the three variations' descriptions


@pytest.mark.parametrize("family, dataset", [
    ("exp_rlbench_act_policy", "RLBenchSingleTaskACTPCDDataset"),
    ("exp_rlbench_diffusion_policy", "RLBenchSingleTaskDiffusionPolicyPCDDataset")])
def test_preprocessed_episodes_load_in_the_port_datasets(family, dataset, preprocessed,
                                                         tmp_path):
    from pointcloudmatters_tpu_torch.utils import config as C

    root = preprocessed / "port"
    cfg = _composed([f"{family}=base", f"{family}/rlbench_model@rlbench_model="
                     "scratch_pointnet_pcd", "rlbench_task=close_jar",
                     f"data.train.root={root}/train", f"data.val.root={root}/val",
                     "data.num_workers=0"], tmp_path)
    data = C.instantiate(cfg.data)
    data.setup("fit")
    assert type(data.data_train).__name__ == dataset
    assert len(data.data_train) > 0
    for sample in (data.data_train[0], data.data_val[len(data.data_val) - 1]):
        leaves = [v for v in _leaves(sample) if torch.is_tensor(v) or isinstance(v, np.ndarray)]
        assert leaves and all(np.isfinite(np.asarray(v, np.float64)).all() for v in leaves)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
