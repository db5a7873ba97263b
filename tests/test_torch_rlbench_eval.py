"""The port's closed loops against the JAX package's, on the CPU, with fake
simulators, and the RLBench entry points end to end.

- Both RLBench evaluation loops (``envs/rlbench_eval.py``) against a fake
  task that throws an IK error (``RuntimeError``, the loops' error type
  where PyRep is absent) at step 0: given the same predictions, the actions
  handed to ``step_fn`` within 1e-6 of JAX's (the 6D ensembling's rotation
  conversions run in f32 in both; XLA and torch round them alike to a few
  ulps) and the same success rate; with and without temporal aggregation,
  collision on and off.
- ``build_act_obs`` / ``build_dp_obs`` (``envs/rollout.py``) bit-equal to
  JAX's over the ManiSkill2 datasets of both packages (point clouds, with a
  random crop and the ground, a pointmap, RGB-D images).
- ``run_maniskill2_rollouts`` serial and over a pool of 4 envs, equal to
  each other and to JAX's (metrics, and every action each episode's env
  took, bit for bit: TemporalAgg is numpy in both), on the staged
  PegInsertion protocol; ``run_maniskill2_dp_rollouts`` equal to JAX's.
- The ManiSkill2 ACT and DP task modules' ``val/mean_success`` on the
  fake env of JAX's ``tests/test_training.py:400-460`` (success at step 3),
  and on one whose success follows the seed: equal to JAX's loop given the
  port policy's predictions, at ``num_envs`` 1 and 4; PegInsertion's
  ``val/mean_grasp`` and ``val/mean_align``; the reward curves in
  TensorBoard; an error inside an episode propagating. The custom env
  registry registers nothing without ``mani_skill2``, as JAX's.
- ``Trainer(profiler="simple")`` writes a ``torch.profiler`` trace of the
  fit loop.
- The CLI: ``python -m pointcloudmatters_tpu_torch.train`` on
  ``exp_rlbench_act_policy`` (tiny widths, the CPU, synthetic episodes, one
  epoch), then ``test_rlbench_act.main`` and ``test_rlbench_dp.main`` (on a
  tiny DP trained in the process) on their checkpoints with a fake task in
  place of ``rlbench_utils.build_env_and_task`` / ``reset_task`` and a
  ``CachedTextEncoder`` cache: the line each appends to the result file.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.envs import rlbench_eval as jeval
from pointcloudmatters_tpu.envs import rollout as jrollout
from pointcloudmatters_tpu.data.components import maniskill2 as jms2
from pointcloudmatters_tpu.data.components import transformpcd as JT
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.data.components import maniskill2 as tms2
from pointcloudmatters_tpu_torch.data.components import transformpcd as T
from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset
from pointcloudmatters_tpu_torch.envs import rlbench_eval as teval
from pointcloudmatters_tpu_torch.envs import rollout as trollout
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2ACTBCModule,
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import profiling
from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU
from test_torch_data import _equal, _flagship_transforms
from tests.synth import make_synthetic_maniskill2, make_synthetic_rlbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "close_jar"
CAM_SIDE = 16  # 256 points a camera
TINY_ACT = dict(hidden_dim=32, npoints=16, nsample=4, chunk=5, enc_layers=1, dec_layers=1,
                nhead=4, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread, as the test processes run several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the RLBench loops
# ---------------------------------------------------------------------------

class FakeTask:
    """RLBench's ``reset_to_demo`` / ``step`` contract: an IK error at the
    first try of each episode, success at step 3 of even episodes, the end
    at step 6; every action taken kept."""

    def __init__(self):
        self.actions = []

    def reset(self, ep):
        self.ep, self.t, self.failed = ep, 0, False
        return f"close the jar {ep}", {"ep": ep, "t": 0}

    def step(self, action):
        if not self.failed:
            self.failed = True
            raise RuntimeError("IK failed")
        self.actions.append(np.asarray(action).copy())
        self.t += 1
        success = self.ep % 2 == 0 and self.t == 3
        return {"ep": self.ep, "t": self.t}, float(success), self.t >= 6


def _chunk(obs, description, rows, width):
    """A prediction that follows the observation: normalized positions,
    unit quaternions, gripper (and collision) scores in (0, 1)."""
    obs = obs[-1] if isinstance(obs, list) else obs
    rng = np.random.RandomState(1000 * obs["ep"] + obs["t"] + len(description))
    chunk = rng.uniform(-0.9, 0.9, (rows, width)).astype(np.float32)
    quat = rng.randn(rows, 4)
    chunk[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    chunk[:, 7:] = rng.rand(rows, width - 7)
    return chunk


@pytest.mark.parametrize("temporal_agg", [True, False])
@pytest.mark.parametrize("collision", [True, False])
def test_rlbench_act_loop_matches_jax(temporal_agg, collision):
    width = 9 if collision else 8
    runs = []
    for loop in (jeval.run_rlbench_act_eval, teval.run_rlbench_act_eval):
        task = FakeTask()
        rate = loop(predict=lambda o, d: _chunk(o, d, 4, width), reset_fn=task.reset,
                    step_fn=task.step, task_name=TASK, episodes_num=3, max_steps=8,
                    collision=collision, temporal_agg=temporal_agg,
                    agg_action_dim=width + 2, agg_chunk_size=4)
        runs.append((rate, np.stack(task.actions)))
    (ref_rate, ref), (rate, got) = runs
    assert rate == ref_rate == 2 / 3
    assert got.shape == ref.shape == (3 + 6 + 3, width)  # episode 1 fails: 6 steps
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 7:], ref[:, 7:])  # thresholded at 0.5


@pytest.mark.parametrize("collision", [True, False])
def test_rlbench_dp_loop_matches_jax(collision):
    width = 9 if collision else 8
    runs = []
    for loop in (jeval.run_rlbench_dp_eval, teval.run_rlbench_dp_eval):
        task, hist = FakeTask(), []

        def predict(h, d):
            hist.append(len(h))
            return _chunk(h, d, 2, width)

        rate = loop(predict=predict, reset_fn=task.reset, step_fn=task.step, task_name=TASK,
                    n_obs_steps=2, episodes_num=3, max_steps=8, collision=collision)
        runs.append((rate, np.stack(task.actions), hist))
    (ref_rate, ref, ref_hist), (rate, got, hist) = runs
    assert rate == ref_rate and hist == ref_hist and set(hist) == {2}
    np.testing.assert_array_equal(got, ref)


def test_unnormalize_and_threshold_match_jax():
    a = np.random.RandomState(0).uniform(-1, 1, (5, 9))
    ref = jeval._threshold_gripper(jeval.unnormalize_position(a, TASK), True)
    got = teval._threshold_gripper(teval.unnormalize_position(a, TASK), True)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the ManiSkill2 observations and rollouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ms2") / "trajectory.pointcloud.pd_ee_delta_pose.h5"
    return make_synthetic_maniskill2(str(path), n_episodes=3, episode_len=8, cam_side=CAM_SIDE)


def _env_obs(seed, t=0, image=False):
    """A ManiSkill2 observation: one camera's cloud (a fifth of it w = 0,
    some on the ground) or RGB-D image, qpos, the goal."""
    rng = np.random.RandomState(seed * 100 + t)
    n = CAM_SIDE * CAM_SIDE
    obs = {"agent": {"qpos": rng.randn(9).astype(np.float32)},
           "extra": {"goal_pos": rng.randn(3).astype(np.float32)}}
    if image:
        obs["image"] = {"base_camera": {
            "rgb": rng.randint(0, 255, (32, 32, 3)).astype(np.uint8),
            "depth": rng.rand(32, 32, 1).astype(np.float32)}}
    else:
        xyz = rng.rand(n, 3).astype(np.float32) * 0.3
        xyz[: n // 8, 2] = 0.0
        w = (rng.rand(n, 1) > 0.2).astype(np.float32)
        obs["pointcloud"] = {"xyzw": np.concatenate([xyz, w], -1),
                             "rgb": rng.randint(0, 255, (n, 3)).astype(np.uint8)}
    return obs


OBS_DATASETS = {
    "pcd": ("ManiSkill2GoalPosSingleTaskACTPCDDataset", {}),
    "pcd_crop_ground": ("ManiSkill2GoalPosSingleTaskACTPCDDataset",
                        dict(rand_crop=True, include_ground=True)),
    "pointmap": ("ManiSkill2GoalPosSingleTaskACTPCDDataset", dict(pointmap=True)),
    "rgbd": ("ManiSkill2GoalPosSingleTaskACTRGBDDataset", dict(include_depth=True)),
    "dp_pcd": ("ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset", {}),
    "dp_pcd_crop": ("ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset",
                    dict(rand_crop=True)),
    "dp_pointmap": ("ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset",
                    dict(pointmap=True)),
}


def _obs_dataset(mod, kind, h5file, cache):
    name, kw = OBS_DATASETS[kind]
    kw = dict(kw, goal_cond_keys=["goal_pos"], cache_dir=cache,
              chunk_size=4 if kind.startswith("dp") else TINY_ACT["chunk"])
    if "rgbd" in kind:
        return getattr(mod, name)(dataset_file=h5file, camera_names=["base_camera"], **kw)
    pkg = JT if mod is jms2 else T
    return getattr(mod, name)(dataset_file=h5file, transform_pcd=_flagship_transforms(pkg),
                              point_num_per_cam=CAM_SIDE * CAM_SIDE, **kw)


@pytest.mark.parametrize("kind", list(OBS_DATASETS))
def test_policy_observations_match_jax(kind, h5file, tmp_path):
    """The rollouts' policy inputs from an env observation, bit-equal: the
    dataset's statistics and test-mode transforms, padded to 64."""
    ref_ds = _obs_dataset(jms2, kind, h5file, str(tmp_path / "jax"))
    got_ds = _obs_dataset(tms2, kind, h5file, str(tmp_path / "torch"))
    for seed in range(3):
        obs = [_env_obs(seed, t, image="rgbd" in kind) for t in range(2)]
        if kind.startswith("dp"):
            ref = jrollout.build_dp_obs(obs, ref_ds, pad_multiple=64)
            got = trollout.build_dp_obs(obs, got_ds, pad_multiple=64)
        else:
            ref = jrollout.build_act_obs(obs[0], ref_ds, pad_multiple=64)
            got = trollout.build_act_obs(obs[0], got_ds, pad_multiple=64)
        _equal(got, ref)


class SeededEnv:
    """A gymnasium env whose observations, rewards and PegInsertion stages
    follow the seed and the step; success on seeds divisible by 3; every
    action kept by seed."""

    taken: dict = {}
    lock = threading.Lock()

    def reset(self, seed=None, options=None):
        self.seed, self.t = seed, 0
        return _env_obs(seed), {}

    def step(self, action):
        with self.lock:
            self.taken.setdefault(self.seed, []).append(np.asarray(action).copy())
        self.t += 1
        done = self.t >= 4
        info = {"success": done and self.seed % 3 == 0, "is_grasped": self.t >= self.seed % 4,
                "pre_inserted": self.t >= 3 and self.seed % 2 == 0}
        return _env_obs(self.seed, self.t), float(self.t) / 4, done, False, info

    def close(self):
        pass


def _numpy_policy(data):
    """Predictions that follow the whole input (qpos, goal, cloud)."""
    s = float(data["qpos"].sum() + data["goal_cond"].sum() + data["pcds"]["coord"].sum())
    return np.tanh(s * np.linspace(0.1, 1.0, 5 * 7)).reshape(1, 5, 7).astype(np.float32)


def test_rollouts_serial_pooled_and_jax_agree(h5file, tmp_path):
    """The staged PegInsertion protocol over 6 episodes: the JAX loop, the
    port's serially and over 4 envs; the metrics and every env's actions
    equal."""
    ref_ds = _obs_dataset(jms2, "pcd", h5file, str(tmp_path / "jax"))
    got_ds = _obs_dataset(tms2, "pcd", h5file, str(tmp_path / "torch"))
    kw = dict(predict=_numpy_policy, env_id="PegInsertionSide-v0", n_episodes=6, action_dim=7,
              num_queries=5, temporal_agg=True, max_steps=6, pad_multiple=64)
    results = []
    for run in (lambda: jrollout.run_maniskill2_rollouts(env=SeededEnv(), dataset=ref_ds, **kw),
                lambda: trollout.run_maniskill2_rollouts(env=SeededEnv(), dataset=got_ds, **kw),
                lambda: trollout.run_maniskill2_rollouts(env=None, env_factory=SeededEnv,
                                                         num_envs=4, dataset=got_ds, **kw)):
        SeededEnv.taken = {}
        results.append((run(), SeededEnv.taken))
    (ref, ref_taken), *ours = results
    assert set(ref) == {"mean_success", "mean_grasp", "mean_align"}
    assert ref["mean_success"] == 2 / 6
    for got, taken in ours:
        assert got == ref
        _equal(dict(sorted(taken.items())), ref_taken)  # a pool finishes in any order


def test_dp_rollouts_match_jax(h5file, tmp_path):
    ref_ds = _obs_dataset(jms2, "dp_pcd", h5file, str(tmp_path / "jax"))
    got_ds = _obs_dataset(tms2, "dp_pcd", h5file, str(tmp_path / "torch"))

    def predict(data):
        s = float(data["obs"]["qpos"].sum() + data["obs"]["pcds"]["coord"].sum())
        return np.tanh(s * np.linspace(0.1, 1.0, 3 * 7)).reshape(1, 3, 7).astype(np.float32)

    results = []
    for loop, ds in ((jrollout.run_maniskill2_dp_rollouts, ref_ds),
                     (trollout.run_maniskill2_dp_rollouts, got_ds)):
        SeededEnv.taken = {}
        results.append((loop(predict=predict, dataset=ds, env=SeededEnv(), env_id="PickCube-v0",
                             n_episodes=4, n_obs_steps=2, max_steps=7, pad_multiple=64),
                        SeededEnv.taken))
    assert results[0][0] == results[1][0]
    _equal(results[1][1], results[0][1])


class FakeEnv:
    """JAX's ``tests/test_training.py`` fake env: random clouds, success at
    step 3."""

    def __init__(self):
        self.rng = np.random.RandomState(0)

    def _obs(self):
        n = CAM_SIDE * CAM_SIDE
        xyz = self.rng.rand(n, 3).astype(np.float32) * 0.3
        w = (self.rng.rand(n, 1) > 0.2).astype(np.float32)
        return {"agent": {"qpos": self.rng.randn(9).astype(np.float32)},
                "pointcloud": {"xyzw": np.concatenate([xyz, w], -1),
                               "rgb": self.rng.randint(0, 255, (n, 3)).astype(np.uint8)},
                "extra": {"goal_pos": self.rng.randn(3).astype(np.float32)}}

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        assert np.asarray(action).shape == (7,)
        self.t += 1
        done = self.t >= 3
        return self._obs(), 0.5, done, False, {"success": done}

    def close(self):
        pass


def _ms2_module(kind, h5file, cache, num_envs, env):
    if kind == "act":
        ds = _obs_dataset(tms2, "pcd", h5file, cache)
        module = ManiSkill2ACTBCModule(tentry.build_flagship(**TINY_ACT, device="cpu"),
                                       env_id="PickCube-v0", num_envs=num_envs)
    else:
        ds = _obs_dataset(tms2, "dp_pcd", h5file, cache)
        policy = tentry.build_dp_policy(npoints=16, nsample=4, hidden_dim=32,
                                        projector_channels=(32, 48, 48), num_classes=32,
                                        horizon=4, n_action_steps=2, num_train_timesteps=5,
                                        num_inference_steps=3, down_dims=(16, 32),
                                        diffusion_step_embed_dim=16, device="cpu")
        policy.normalizer = ds.get_normalizer()
        module = ManiSkill2DiffusionPolicyBCModule(policy, env_id="PickCube-v0",
                                                   num_envs=num_envs)
    module.env_factory = lambda m: env()
    data = BaseDataModule(train=ds, val=DummyDataset(size=4), batch_size_train=2,
                          pin_memory=False, pad_multiple=64)
    return module, data, ds


@pytest.mark.parametrize("kind", ["act", "dp"])
def test_module_validates_by_rollouts_on_jax_fake_env(kind, h5file, tmp_path):
    """JAX's fake env succeeds at step 3 of every episode: val/mean_success
    1.0, as JAX's test asserts (through ``fit`` for ACT)."""
    module, data, _ = _ms2_module(kind, h5file, str(tmp_path), 1, FakeEnv)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      limit_train_batches=1, limit_val_batches=2, seed=0)
    if kind == "act":
        trainer.fit(module, data)
        out = {k: float(v) for k, v in module.best_val_metrics.compute().items()}
    else:
        out = module.run_validation(trainer, data)
    assert out == {"val/mean_success": 1.0}


def test_rollout_reward_curves_reach_tensorboard(h5file, tmp_path):
    """Each episode's reward curve goes to a logger that takes figures (the
    TensorBoard logger), as in JAX: one ``val/rewards_<idx>`` image an
    episode."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from pointcloudmatters_tpu_torch.utils.loggers import TensorBoardLogger

    module, data, _ = _ms2_module("act", h5file, str(tmp_path), 1, SeededEnv)
    logger = TensorBoardLogger(str(tmp_path))
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", logger=logger,
                      limit_val_batches=2)
    module.run_validation(trainer, data)
    logger.finalize()
    events = EventAccumulator(logger.save_dir, size_guidance={"images": 0})
    events.Reload()
    assert sorted(events.Tags()["images"]) == ["val/rewards_0", "val/rewards_1"]


@pytest.mark.parametrize("kind", ["act", "dp"])
def test_module_success_equals_jax_loop_at_one_and_four_envs(kind, h5file, tmp_path):
    """Over SeededEnv (success on seeds divisible by 3), the module's
    val/mean_success at num_envs 1 and 4 equals JAX's loop fed the port
    policy's own predictions."""
    outs = []
    for num_envs in ((1, 4) if kind == "act" else (1,)):
        module, data, ds = _ms2_module(kind, h5file, str(tmp_path), num_envs, SeededEnv)
        trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", seed=0)
        outs.append(module.run_validation(trainer, data))
    assert all(out == outs[0] for out in outs)
    jds = _obs_dataset(jms2, "pcd" if kind == "act" else "dp_pcd", h5file, str(tmp_path / "j"))
    if kind == "act":
        ref = jrollout.run_maniskill2_rollouts(
            predict=lambda d: module.predict(d).numpy(), dataset=jds, env=SeededEnv(),
            env_id="PickCube-v0", n_episodes=4, action_dim=7, num_queries=5, pad_multiple=64)
    else:
        gen = torch.Generator().manual_seed(0)
        ref = jrollout.run_maniskill2_dp_rollouts(
            predict=lambda d: module.predict(d, gen).numpy(), dataset=jds, env=SeededEnv(),
            env_id="PickCube-v0", n_episodes=4, n_obs_steps=2, pad_multiple=64)
    assert outs[0] == {"val/mean_success": np.float32(ref["mean_success"]).item()}


def test_staged_peg_insertion_logs_grasp_and_align(h5file, tmp_path):
    """On PegInsertionSide-v0 (its staged evaluator) the module logs
    ``val/mean_grasp`` and ``val/mean_align`` beside ``val/mean_success``,
    JAX's loop's values given the port policy's predictions."""
    module, data, _ = _ms2_module("act", h5file, str(tmp_path), 1, SeededEnv)
    module.env_id = "PegInsertionSide-v0"
    out = module.run_validation(Trainer(default_root_dir=str(tmp_path), accelerator="cpu"),
                                data)
    ref = jrollout.run_maniskill2_rollouts(
        predict=lambda d: module.predict(d).numpy(),
        dataset=_obs_dataset(jms2, "pcd", h5file, str(tmp_path / "j")), env=SeededEnv(),
        env_id="PegInsertionSide-v0", n_episodes=4, action_dim=7, num_queries=5,
        pad_multiple=64)
    assert out == {f"val/{k}": np.float32(v).item() for k, v in ref.items()}
    assert set(out) == {"val/mean_success", "val/mean_grasp", "val/mean_align"}


def test_custom_envs_register_nothing_without_the_simulator():
    """Without ``mani_skill2`` the registry imports and registers nothing,
    as JAX's; its env-ID surface is JAX's."""
    from pointcloudmatters_tpu.envs import custom_maniskill2 as jcustom
    from pointcloudmatters_tpu_torch.envs import custom_maniskill2 as tcustom

    assert tcustom.register_custom_envs() is False
    assert tcustom.iter_env_ids() == jcustom.iter_env_ids()
    assert tcustom.MPM_RIGS.keys() == jcustom.MPM_RIGS.keys()


def test_an_error_inside_an_episode_propagates(h5file, tmp_path):
    """Only a failure to build the env falls back to the held-out loss."""
    class Broken(SeededEnv):
        def step(self, action):
            raise ValueError("the episode broke")

    module, data, _ = _ms2_module("act", h5file, str(tmp_path), 1, Broken)
    with pytest.raises(ValueError, match="the episode broke"):
        module.run_validation(Trainer(default_root_dir=str(tmp_path), accelerator="cpu"), data)


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_trainer_profiler_writes_a_trace(h5file, tmp_path):
    """``profiler="simple"`` (``configs/debug/profiler.yaml``) traces the fit
    loop: a Chrome trace with the step's ops and a summary table."""
    ds = _obs_dataset(tms2, "pcd", h5file, str(tmp_path))
    module = BCModule(tentry.build_flagship(**TINY_ACT, device="cpu"),
                      optimizer={"type": "AdamW", "lr": 1e-4})
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      limit_train_batches=2, check_val_every_n_epoch=0, profiler="simple")
    trainer.fit(module, BaseDataModule(train=ds, batch_size_train=2, pin_memory=False,
                                       pad_multiple=64))
    out = tmp_path / "torch_trace"
    with open(out / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert "aten::addmm" in (out / profiling.SUMMARY_FILE).read_text()
    assert profiling.device_memory_stats() == {}  # no card here


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

TINY_RLBENCH = [
    "data.train.chunk_size=4", "data.batch_size_train=2", "data.batch_size_val=2",
    "data.pad_multiple=64", "data.num_workers=0", "model.policy.hidden_dim=32",
    "model.policy.pcd_npoints=16", "model.policy.pcd_nsample=4",
    "model.policy.transformer.num_encoder_layers=1",
    "model.policy.transformer.num_decoder_layers=1", "model.policy.transformer.nhead=4",
]


def _rlbench_argv(root, out, family="exp_rlbench_act_policy"):
    return [f"{family}=base", f"{family}/rlbench_model@rlbench_model=scratch_pointnet_pcd",
            f"rlbench_task={TASK}", f"data.train.root={root}/train",
            f"data.val.root={root}/val", "trainer.accelerator=cpu", "trainer.max_epochs=1",
            "trainer.check_val_every_n_epoch=1", "logger=csv", "callbacks.early_stopping=null",
            f"paths.log_dir={out}/logs", f"hydra.run.dir={out}/run"]


class EvalTask:
    """The RLBench task the entry points see: ``reset_task`` hands out a
    description and an observation of the processed episodes' layout,
    ``step`` throws one IK error at the first try, then succeeds at step 2
    of episode 0."""

    def __init__(self, root):
        episode = np.load(os.path.join(root, "train", TASK, "ep0.npy"), allow_pickle=True).item()
        self.frames = episode["demo"]
        self.steps, self.failed = [], False

    def reset(self, ep):
        self.ep, self.t, self.failed = ep, 0, False
        return "close the jar", self.frames[0]

    def step(self, action):
        if not self.failed:
            self.failed = True
            raise RuntimeError("IK failed")
        self.steps.append(np.asarray(action))
        self.t += 1
        return self.frames[self.t % len(self.frames)], float(self.ep == 0 and self.t == 2), False

    def shutdown(self):
        pass


def _fake_simulator(monkeypatch, task):
    monkeypatch.setattr(RU, "build_env_and_task", lambda cfg: (task, task))
    monkeypatch.setattr(RU, "reset_task", lambda t, cfg, ep: (t, None, [t.reset(ep)[0]],
                                                              t.reset(ep)[1]))


def _clip_cache(path):
    cache = RU.CachedTextEncoder(str(path))
    cache.put("close the jar", np.random.RandomState(0).randn(512).astype(np.float32))
    cache.save()
    return str(path)


def test_rlbench_act_cli_trains_and_evaluates(tmp_path, monkeypatch):
    """``python -m pointcloudmatters_tpu_torch.train`` on the ACT
    composition for one epoch (held-out validation, ``last`` checkpoint),
    then ``test_rlbench_act.main`` on ``last``: 2 episodes of at most 4
    steps against the fake task, the goal from the embedding cache; the
    result file holds ``<ckpt_path>: 0.5``."""
    from pointcloudmatters_tpu_torch import test_rlbench_act

    root = make_synthetic_rlbench(str(tmp_path / "data"), task_name=TASK, n_episodes=2,
                                  episode_len=6)
    argv = _rlbench_argv(root, tmp_path) + TINY_RLBENCH
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", "pointcloudmatters_tpu_torch.train", *argv],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = tmp_path / "run" / "checkpoints" / "last"
    assert (last / "checkpoint.pt").exists()
    task = EvalTask(root)
    _fake_simulator(monkeypatch, task)
    result = tmp_path / "results"
    metrics = test_rlbench_act.main(
        argv + [f"ckpt_path={last}", "episodes_num=2", "max_steps=4", f"result_path={result}",
                f"clip_cache_path={_clip_cache(tmp_path / 'clip.npz')}"])
    assert metrics == {"success_rate": 0.5}
    assert (result / "test_result.txt").read_text() == f"{last}: 0.5\n"
    assert len(task.steps) == 2 + 4 and all(a.shape == (9,) for a in task.steps)


def test_rlbench_dp_entry_point_evaluates(tmp_path, monkeypatch):
    """A tiny RLBench DP trained in the process (``train.main``, one
    epoch), then ``test_rlbench_dp.main`` on its checkpoint: every one of
    a prediction's 2 actions executed, the result line written."""
    from pointcloudmatters_tpu_torch import test_rlbench_dp, train

    root = make_synthetic_rlbench(str(tmp_path / "data"), task_name=TASK, n_episodes=2,
                                  episode_len=6)
    argv = _rlbench_argv(root, tmp_path, "exp_rlbench_diffusion_policy") + [
        "data.train.chunk_size=4", "data.batch_size_train=2", "data.batch_size_val=2",
        "data.pad_multiple=64", "data.num_workers=0", "model.policy.n_action_steps=2",
        "model.policy.num_inference_steps=3", "model.policy.noise_scheduler.num_train_timesteps=3",
        "model.policy.diffusion_step_embed_dim=16", "model.policy.down_dims=[16,32]",
        "model.policy.obs_encoder.pcd_npoints=16", "model.policy.obs_encoder.pcd_nsample=4",
        "model.policy.obs_encoder.pcd_hidden_dim=16",
        "model.policy.obs_encoder.projector_channels=[16,32,32]",
        "model.policy.obs_encoder.pcd_model.num_classes=16"]
    train.main(argv)
    last = tmp_path / "run" / "checkpoints" / "last"
    task = EvalTask(root)
    _fake_simulator(monkeypatch, task)
    metrics = test_rlbench_dp.main(
        argv + [f"ckpt_path={last}", "episodes_num=2", "max_steps=4",
                f"result_path={tmp_path / 'results'}",
                f"clip_cache_path={_clip_cache(tmp_path / 'clip.npz')}"])
    assert metrics == {"success_rate": 0.5}
    assert (tmp_path / "results" / "test_result.txt").read_text() == f"{last}: 0.5\n"
    # the DP's actions reach the task as the policy gives them, its 6D
    # rotation unconverted, as in JAX (ROADMAP.md §3)
    assert len(task.steps) == 2 + 4 and all(a.shape == (11,) for a in task.steps)
