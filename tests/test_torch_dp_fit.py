"""The port's Diffusion Policy trained as the JAX package trains it, on the
CPU: ``Trainer.fit`` of the DP task module over the ported DP point-cloud
dataset against the JAX ``Trainer.fit``, and ``python -m
pointcloudmatters_tpu_torch.train`` on the shipped DP composition.

Both fits read the same synthetic demo file (``tests/synth.py``) and draw
their samples from numpy's global stream, seeded alike; the port loads the
variables the JAX trainer initialised. A jitted JAX step bakes its draws in
at its first trace, so both sides take one fixed noise and timestep draw:
the JAX module's ``make_rng`` returns a fixed key, and the port's
``training_draws`` what JAX draws from it (``test_torch_diffusion_policy.py``'s
``fixed_rng``).
"""

import csv
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.data.base_datamodule import BaseDataModule as JDataModule
from pointcloudmatters_tpu.data.components import transformpcd as JT
from pointcloudmatters_tpu.data.components.maniskill2 import (
    ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset as JDataset,
)
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components import pretrained as jpretrained
from pointcloudmatters_tpu.models.maniskill2_modules import (
    ManiSkill2DiffusionPolicyBCModule as JDPModule,
)
from pointcloudmatters_tpu.trainer import Trainer as JTrainer
from pointcloudmatters_tpu.utils.loggers import CSVLogger as JCSVLogger
from pointcloudmatters_tpu.utils.metrics import Metrics as JMetrics
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.data.components import transformpcd as T
from pointcloudmatters_tpu_torch.data.components.maniskill2 import (
    ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset,
)
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.trainer import Trainer, read_checkpoint
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from pointcloudmatters_tpu_torch.utils.loggers import CSVLogger
from pointcloudmatters_tpu_torch.utils.metrics import Metrics
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_diffusion_policy import (  # noqa: F401
    _jax_policy,
    _torch_policy,
    fixed_rng,
    one_torch_thread,
)
from tests.synth import make_synthetic_maniskill2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# SGD, as tests/test_torch_ddp.py's accumulation test: AdamW turns the
# rounding noise of the exact-zero gradients (ZERO_GRAD) into steps of lr,
# which the batch norms' running means after those biases then record
OPT = {"type": "SGD", "lr": 1e-2, "momentum": 0.9}
CAM_SIDE = 16  # 256 points a camera
BATCH = 4  # 8 clouds a batch norm sees (see test_policy_loss_and_gradients_match_jax)
N_TRAIN = 4  # micro-batches an epoch


def _transforms(pkg):
    """The DP config's point-cloud transforms at a grid that puts several
    points in a voxel of the small synthetic clouds."""
    return [pkg.GridSamplePCD(grid_size=0.02, hash_type="fnv", mode="train",
                              return_grid_coord=True, keys=("coord", "color")),
            pkg.NormalizeColorPCD(), pkg.ShufflePointPCD(), pkg.ToTensorPCD(),
            pkg.CollectPCD(keys=("coord", "grid_coord"), feat_keys=("color", "coord"))]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_fit_data")
    return tuple(make_synthetic_maniskill2(
        str(root / f"{name}.h5"), n_episodes=3, episode_len=12, cam_side=CAM_SIDE, seed=seed)
        for name, seed in (("train", 0), ("val", 1)))


def _datamodule(jax_side, files, cache_dir):
    Dataset, DataModule, pkg = ((JDataset, JDataModule, JT) if jax_side else
                                (ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset,
                                 BaseDataModule, T))

    def dataset(path, loop):
        return Dataset(n_obs_steps=2, dataset_file=path, goal_cond_keys=["goal_pos"],
                       chunk_size=8, transform_pcd=_transforms(pkg), cache_dir=cache_dir,
                       point_num_per_cam=CAM_SIDE * CAM_SIDE, loop=loop)

    return DataModule(train=dataset(files[0], 8), val=dataset(files[1], 1),
                      batch_size_train=BATCH, batch_size_val=2, num_workers=0,
                      pin_memory=False, pad_multiple=CAM_SIDE * CAM_SIDE)


def _held_out(base, metrics, run_validation):
    """``base`` (a package's DP task module) validating by its held-out loss,
    as ``chip_smoke.held_out_dp_module`` makes the port's: the shipped one
    needs the simulator."""

    class HeldOut(base):
        @property
        def val_metric_keys(self):
            return ["loss"]

        def run_validation(self, trainer, datamodule):
            return run_validation(self, trainer, datamodule)

    def build(policy):
        return HeldOut(policy, optimizer=OPT,
                       val_metrics=metrics(["MeanMetric"], ["loss"], ["val/loss"]),
                       best_val_metrics=metrics(["MinMetric"], ["val/loss"],
                                                ["val/loss_best"]))

    return build


class Record:
    """Keeps the metrics and the model's state at each epoch's end."""

    def __init__(self, state):
        self.state, self.epochs, self.val = state, [], []

    def setup(self, trainer, model):
        pass

    def on_fit_start(self, trainer, model):
        pass

    def on_validation_end(self, trainer, model, metrics, epoch):
        self.val.append(dict(metrics))

    def on_train_epoch_end(self, trainer, model, metrics, epoch):
        self.epochs.append((dict(metrics), self.state(trainer, model)))

    def on_fit_end(self, trainer, model):
        pass


def _fit_kwargs(tmp_path, name):
    return dict(default_root_dir=str(tmp_path), max_epochs=2, accelerator="cpu", devices=1,
                precision="32-true", accumulate_grad_batches=2, gradient_clip_val=1.0,
                limit_train_batches=N_TRAIN, limit_val_batches=2, log_every_n_steps=1,
                logger=(JCSVLogger if name == "jax" else CSVLogger)(str(tmp_path), name=name))


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_dp_fit_matches_jax(files, tmp_path, monkeypatch, fixed_rng):
    """2 epochs of 4 micro-batches of 4, k = 2, a clip, held-out validation
    after each epoch, SGD with momentum: the normalizer each trainer wires
    from the dataset, the per-step losses and gradient norms (1e-4
    relative), the epoch metrics and held-out losses (1e-4 relative), and
    the parameters and batch statistics after each epoch, within
    ``tests/test_torch_fit.py``'s limits (parameters 2e-6 + 1e-4 of a
    tensor's largest entry, statistics 1e-5)."""
    initial = {}

    def capture(policy, variables):
        initial.update(jax.tree.map(np.asarray, variables))
        return variables

    monkeypatch.setattr(jpretrained, "load_pretrained_into", capture)
    # the JAX module jits a new eval step at each validation; one compile
    # serves both here (the step is a pure function of the module)
    monkeypatch.setattr(JTrainer, "_build_eval_step", functools.cache(JTrainer._build_eval_step))
    jrec = Record(lambda trainer, model: {
        "params": jax.tree.map(np.asarray, trainer.state.params),
        "batch_stats": jax.tree.map(np.asarray, trainer.state.batch_stats)})
    jmodule = _held_out(JDPModule, JMetrics, JBCModule.run_validation)(_jax_policy())
    jtrainer = JTrainer(**_fit_kwargs(tmp_path, "jax"), callbacks=[jrec], prng_impl=None)
    np.random.seed(0)
    jtrainer.fit(jmodule, _datamodule(True, files, str(tmp_path / "jax_cache")))

    rec = Record(lambda trainer, model: {k: v.detach().clone()
                                         for k, v in model.policy.state_dict().items()})
    module = _held_out(ManiSkill2DiffusionPolicyBCModule, Metrics, BCModule.run_validation)(
        _torch_policy())
    module.load_variables(initial)
    trainer = Trainer(**_fit_kwargs(tmp_path, "torch"), callbacks=[rec])
    np.random.seed(0)
    trainer.fit(module, _datamodule(False, files, str(tmp_path / "torch_cache")))

    for key in ("action", "qpos"):
        np.testing.assert_array_equal(module.policy.normalizer[key].scale,
                                      jmodule.policy.normalizer[key].scale)
        np.testing.assert_array_equal(module.policy.normalizer[key].offset,
                                      jmodule.policy.normalizer[key].offset)
    assert set(module.state_dict_extras()["normalizer"]) == {"action", "qpos"}
    assert trainer.global_step == jtrainer.global_step == 2 * N_TRAIN
    for epoch, ((got_m, got), (ref_m, ref)) in enumerate(zip(rec.epochs, jrec.epochs)):
        assert set(got_m) == set(ref_m) and "train/loss" in ref_m
        for key in ref_m:
            if key != "samples_per_sec":
                np.testing.assert_allclose(got_m[key], ref_m[key], rtol=1e-4,
                                           err_msg=f"epoch {epoch} {key}")
        ref = flax_to_torch(ref, module.policy)
        for name, r in ref.items():
            r = r.numpy()
            atol = 1e-5 if name.endswith((".mean", ".var")) else 2e-6 + 1e-4 * np.abs(r).max()
            np.testing.assert_allclose(got[name].numpy(), r, atol=atol, rtol=0,
                                       err_msg=f"epoch {epoch} {name}")
    assert len(rec.val) == len(jrec.val) == 2
    for got_v, ref_v in zip(rec.val, jrec.val):
        assert set(got_v) == set(ref_v) == {"val/loss", "val/loss_best"}
        for key in ref_v:
            np.testing.assert_allclose(got_v[key], ref_v[key], rtol=1e-4, err_msg=key)
    rows, jrows = (_read_csv(tmp_path / name / "metrics.csv") for name in ("torch", "jax"))
    steps = [r for r in rows if r.get("grad_norm")]
    jsteps = [r for r in jrows if r.get("grad_norm")]
    assert [r["step"] for r in steps] == [r["step"] for r in jsteps] == [
        str(s) for s in range(1, 2 * N_TRAIN + 1)]
    for r, j in zip(steps, jsteps):
        assert set(r) == set(j) and "action_loss" not in r
        np.testing.assert_allclose(float(r["grad_norm"]), float(j["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(r["loss"]), float(j["loss"]), rtol=1e-4)


def _dp_overrides(tmp_path, demo):
    """The shipped DP composition with tests/test_diffusion_policy.py's tiny
    widths, on the CPU (debug=default: one epoch of 2 batches)."""
    return [
        "exp_maniskill2_diffusion_policy=base",
        "exp_maniskill2_diffusion_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        "exp_maniskill2_diffusion_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
        "debug=default", "logger=csv", "extras.print_config=false",
        f"data.train.dataset_file={demo}", "data.train.point_num_per_cam=256",
        "data.train.chunk_size=8", f"data.train.cache_dir={tmp_path}/cache",
        "+data.train.loop=4", "data.batch_size_train=2", "data.pad_multiple=64",
        "model.policy.num_inference_steps=5", "model.policy.noise_scheduler.num_train_timesteps=5",
        "model.policy.diffusion_step_embed_dim=16", "model.policy.down_dims=[16,32]",
        "model.policy.n_action_steps=4", "model.policy.obs_encoder.pcd_npoints=16",
        "model.policy.obs_encoder.pcd_nsample=4", "model.policy.obs_encoder.pcd_hidden_dim=16",
        "model.policy.obs_encoder.projector_channels=[16,32,32]",
        "model.policy.obs_encoder.pcd_model.num_classes=16",
        f"paths.log_dir={tmp_path}/logs",
    ]


def test_train_main_on_the_dp_composition(files, tmp_path):
    """``python -m pointcloudmatters_tpu_torch.train`` composes and trains
    the shipped DP point-cloud config (tiny overrides, the CPU) for 2
    epochs, writes ``last`` with the dataset's normalizer in its extras,
    bit-equal to the JAX dataset's normalizer of the same file, and a fresh
    module restored from that ``last`` has the normalizer on its policy and
    the saved weights. (Resuming a run through ``ckpt_path`` is
    ``tests/test_torch_cli.py``'s.)"""
    demo = files[0]
    run = tmp_path / "run"
    # one torch thread: beside the other test processes, tiny convolutions
    # on every core run many times slower (see one_torch_thread)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pointcloudmatters_tpu_torch.train",
         *_dp_overrides(tmp_path, demo), "trainer.max_epochs=2", f"hydra.run.dir={run}"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "NotImplementedError" not in proc.stdout + proc.stderr
    last = read_checkpoint(str(run / "checkpoints" / "last"))
    assert (last["epoch"], last["step"]) == (1, 4)
    ref = JDataset(n_obs_steps=2, dataset_file=demo, goal_cond_keys=["goal_pos"], chunk_size=8,
                   transform_pcd=[], cache_dir=str(tmp_path / "jax_cache"),
                   point_num_per_cam=256).get_normalizer()
    saved = last["extras"]["normalizer"]
    assert set(saved) == {"action", "qpos"}
    for key in saved:
        assert isinstance(saved[key]["scale"], torch.Tensor)
        np.testing.assert_array_equal(saved[key]["scale"].numpy(), ref[key].scale)
        np.testing.assert_array_equal(saved[key]["offset"].numpy(), ref[key].offset)

    from pointcloudmatters_tpu_torch import train as train_entry

    cfg = train_entry.compose_run(_dp_overrides(tmp_path, demo)
                                  + [f"hydra.run.dir={tmp_path / 'fresh'}"])
    module = train_entry.instantiate_model(cfg)
    assert type(module) is ManiSkill2DiffusionPolicyBCModule and module.policy.normalizer is None
    Trainer(accelerator="cpu").restore_checkpoint(str(run / "checkpoints" / "last"), module)
    for key in ("action", "qpos"):
        np.testing.assert_array_equal(module.policy.normalizer[key].scale, ref[key].scale)
    for name, value in last["params"].items():
        assert torch.equal(module.policy.state_dict()[name], value), name
