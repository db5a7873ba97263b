"""Parity of the port's ``Trainer.fit`` (gradient accumulation, the epoch
loop, held-out validation, logging) with the JAX ``Trainer.fit``, on the
CPU, over the ported ManiSkill2 data pipeline; and the rest of the fit
surface: metrics, ``_limit``, ``fast_dev_run``, the validation schedule,
the sanity check, the flagship's task module and what is not ported.

Both sides read the same synthetic demo file and draw their samples from
numpy's global stream, seeded alike before each fit; the port loads the
variables the JAX trainer initialised; dropout is 0 and the posterior noise
one numpy array on both sides. Limits are ``test_train_step_matches_jax``'s
(f32, summation order only): parameters 2e-6 + 1e-4 of a tensor's largest
entry (the exact-zero-gradient tensors within 4 lr a step), batch
statistics 1e-5, losses and gradient norms 1e-4 relative, learning rates
1e-5 relative (the JAX schedule runs in f32).
"""

import csv
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.data.base_datamodule import BaseDataModule as JDataModule
from pointcloudmatters_tpu.data.components import transformpcd as JT
from pointcloudmatters_tpu.data.components.maniskill2 import (
    ManiSkill2GoalPosSingleTaskACTPCDDataset as JDataset,
)
from pointcloudmatters_tpu.data.components.misc import DummyDataset as JDummy
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components import pretrained as jpretrained
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu.trainer import Trainer as JTrainer, _limit as jlimit
from pointcloudmatters_tpu.utils import metrics as jmetrics
from pointcloudmatters_tpu.utils.loggers import CSVLogger as JCSVLogger
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.data.components import transformpcd as T
from pointcloudmatters_tpu_torch.data.components.maniskill2 import (
    ManiSkill2GoalPosSingleTaskACTPCDDataset,
)
from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.models.maniskill2_modules import ManiSkill2ACTBCModule
from pointcloudmatters_tpu_torch.trainer import Trainer, _limit
from pointcloudmatters_tpu_torch.utils import metrics as tmetrics
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from pointcloudmatters_tpu_torch.utils.loggers import CSVLogger
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_training import _ZERO_GRAD
from tests.synth import make_synthetic_maniskill2

DIMS = dict(hidden_dim=32, npoints=16, nsample=4, chunk=5, enc_layers=1, dec_layers=1,
            nhead=4)
OPT = {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05}
SCHED = {"scheduler": {"type": "OneCycleLR", "max_lr": 1e-3, "pct_start": 0.1,
                       "anneal_strategy": "cos", "div_factor": 100.0,
                       "final_div_factor": 1000.0}}
CAM_SIDE = 16  # 256 points a camera
BATCH = 2
CLIP = 1.0  # below the tiny policy's gradient norms: the clip acts


def _transforms(pkg):
    """The flagship's point-cloud transforms (``configs/data/
    maniskill2_act_pcd_dataset.yaml``) at a grid that puts several points in
    a voxel of the small synthetic clouds."""
    return [
        pkg.GridSamplePCD(grid_size=0.02, hash_type="fnv", mode="train",
                          return_grid_coord=True, keys=("coord", "color")),
        pkg.NormalizeColorPCD(),
        pkg.ShufflePointPCD(),
        pkg.ToTensorPCD(),
        pkg.CollectPCD(keys=("coord", "grid_coord"), feat_keys=("color", "coord")),
    ]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_data")
    return tuple(make_synthetic_maniskill2(
        str(root / f"{name}.h5"), n_episodes=3, episode_len=12, cam_side=CAM_SIDE, seed=seed)
        for name, seed in (("train", 0), ("val", 1)))


def _datamodule(jax_side, files, cache_dir, val="demo", loop=4):
    """The JAX package's or the port's datamodule over the demo files; the
    validation split a second file, or the configs' ``DummyDataset``."""
    Dataset, DataModule, Dummy, pkg = ((JDataset, JDataModule, JDummy, JT) if jax_side else
                                       (ManiSkill2GoalPosSingleTaskACTPCDDataset,
                                        BaseDataModule, DummyDataset, T))

    def dataset(path, loop):
        return Dataset(path, goal_cond_keys=["goal_pos"], chunk_size=DIMS["chunk"],
                       transform_pcd=_transforms(pkg), cache_dir=cache_dir,
                       point_num_per_cam=CAM_SIDE * CAM_SIDE, loop=loop)

    return DataModule(train=dataset(files[0], loop),
                      val=dataset(files[1], 1) if val == "demo" else Dummy(size=4),
                      batch_size_train=BATCH, batch_size_val=1, num_workers=0,
                      pin_memory=False, pad_multiple=CAM_SIDE * CAM_SIDE)


def _jax_policy():
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6),
        transformer=JTransformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"],
    )


@pytest.fixture
def fixed_noise(monkeypatch):
    eps = np.random.RandomState(3).randn(BATCH, 32).astype(np.float32)
    monkeypatch.setattr(jact, "reparametrize",
                        lambda mu, logvar, key: mu + jnp.exp(0.5 * logvar) * eps[:len(mu)])
    monkeypatch.setattr(tact, "reparametrize", lambda mu, logvar, gen: (
        mu + torch.exp(0.5 * logvar) * torch.from_numpy(eps[:len(mu)])))


class Record:
    """A callback that keeps every hook's call, the metrics handed to it and
    the model's state at the end of each epoch."""

    def __init__(self, state):
        self.state, self.calls, self.epochs, self.val = state, [], [], []

    def setup(self, trainer, model):
        self.calls.append("setup")

    def on_fit_start(self, trainer, model):
        self.calls.append("on_fit_start")

    def on_validation_end(self, trainer, model, metrics, epoch):
        self.calls.append("on_validation_end")
        self.val.append(dict(metrics))

    def on_train_epoch_end(self, trainer, model, metrics, epoch):
        self.calls.append("on_train_epoch_end")
        self.epochs.append((dict(metrics), self.state(trainer, model)))

    def on_fit_end(self, trainer, model):
        self.calls.append("on_fit_end")


def _jax_state(trainer, model):
    return {"params": jax.tree.map(np.asarray, trainer.state.params),
            "batch_stats": jax.tree.map(np.asarray, trainer.state.batch_stats)}


def _torch_state(trainer, model):
    return {k: v.detach().clone() for k, v in model.policy.state_dict().items()}


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _fit_kwargs(n_train, tmp_path, name, **kw):
    return dict(default_root_dir=str(tmp_path), max_epochs=2, accelerator="cpu",
                devices=1, precision="32-true", accumulate_grad_batches=2,
                gradient_clip_val=CLIP, limit_train_batches=n_train, limit_val_batches=2,
                log_every_n_steps=1, logger=(JCSVLogger if name == "jax" else CSVLogger)(
                    str(tmp_path), name=name), **kw)


@pytest.mark.parametrize("n_train", [4, 5])
def test_fit_with_accumulation_matches_jax(n_train, files, tmp_path, monkeypatch,
                                           fixed_noise):
    """k = 2 over ``n_train`` micro-batches an epoch, 2 epochs, a clip that
    acts, held-out validation after each epoch. With 5 the fifth
    micro-batch of epoch 0 opens the mean that epoch 1's first closes."""
    initial = {}

    def capture(policy, variables):
        initial.update(jax.tree.map(np.asarray, variables))
        return variables

    monkeypatch.setattr(jpretrained, "load_pretrained_into", capture)
    jrec = Record(_jax_state)
    jmodule = JBCModule(_jax_policy(), optimizer=OPT, lr_scheduler=SCHED)
    jtrainer = JTrainer(**_fit_kwargs(n_train, tmp_path, "jax"), callbacks=[jrec],
                        prng_impl=None)
    np.random.seed(0)
    jtrainer.fit(jmodule, _datamodule(True, files, str(tmp_path / "jax_cache")))

    rec = Record(_torch_state)
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu"),
                      optimizer=OPT, lr_scheduler=SCHED)
    module.load_variables(initial)
    trainer = Trainer(**_fit_kwargs(n_train, tmp_path, "torch"), callbacks=[rec])
    np.random.seed(0)
    trainer.fit(module, _datamodule(False, files, str(tmp_path / "torch_cache")))

    assert trainer.estimated_stepping_batches == jtrainer.estimated_stepping_batches \
        == (n_train // 2) * 2
    assert trainer.global_step == jtrainer.global_step == 2 * n_train
    assert module.scheduler.last_epoch == n_train  # optimizer steps, both epochs
    assert rec.calls == jrec.calls == ["setup", "on_fit_start"] + [
        "on_validation_end", "on_train_epoch_end"] * 2 + ["on_fit_end"]

    lr_sum = sum(module.scheduler.lr_at(s) for s in range(n_train))
    for epoch, ((got_m, got), (ref_m, ref)) in enumerate(zip(rec.epochs, jrec.epochs)):
        assert set(got_m) == set(ref_m)
        for key in ref_m:
            if key != "samples_per_sec":
                np.testing.assert_allclose(got_m[key], ref_m[key], rtol=1e-4, atol=0,
                                           err_msg=f"epoch {epoch} {key}")
        ref = flax_to_torch(ref, module.policy)
        for name, r in ref.items():
            r = r.numpy()
            if name.endswith((".mean", ".var")):
                atol = 1e-5
            elif any(k in name for k in _ZERO_GRAD):
                atol = 4.0 * lr_sum
            else:
                atol = 2e-6 + 1e-4 * np.abs(r).max()
            np.testing.assert_allclose(got[name].numpy(), r, atol=atol, rtol=0,
                                       err_msg=f"epoch {epoch} {name}")
    assert {"val/loss", "val/loss_best"} <= set(rec.val[0])
    for got_v, ref_v in zip(rec.val, jrec.val):
        assert set(got_v) == set(ref_v)
        for key in ref_v:
            np.testing.assert_allclose(got_v[key], ref_v[key], rtol=1e-4, err_msg=key)

    rows, jrows = (_read_csv(tmp_path / name / "metrics.csv") for name in ("torch", "jax"))
    assert set(rows[0]) == set(jrows[0])
    # a module's first fit logs no learning rate, as in JAX (ROADMAP.md §3)
    assert "lr" not in rows[0]
    steps = [r for r in rows if r.get("grad_norm")]
    jsteps = [r for r in jrows if r.get("grad_norm")]
    assert [r["step"] for r in steps] == [r["step"] for r in jsteps] == [
        str(s) for s in range(1, 2 * n_train + 1)]
    for r, j in zip(steps, jsteps):
        np.testing.assert_allclose(float(r["grad_norm"]), float(j["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(r["loss"]), float(j["loss"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# accumulation on the port alone
# ---------------------------------------------------------------------------

def _snapshots(module):
    """After each micro-step: the parameters and the batch statistics."""
    shots, update = [], module.train_metrics.update

    def spy(outputs, weight=1.0):
        update(outputs, weight)
        shots.append(({n: p.detach().clone() for n, p in module.policy.named_parameters()},
                      {n: b.clone() for n, b in module.policy.named_buffers()
                       if n.endswith((".mean", ".var"))}))

    module.train_metrics.update = spy
    return shots


def test_parameters_bit_equal_after_odd_micro_steps(files, tmp_path):
    """k = 2 over 5 micro-batches an epoch, 2 epochs, dropout on: every
    micro-step moves the batch statistics; the 1st, 3rd, ... of the fit
    leave every parameter bit-equal (no optimizer call: no weight decay,
    no schedule step), the 2nd, 4th, ... move them; the mean opened by
    epoch 0's fifth micro-batch is closed by epoch 1's first (5 optimizer
    steps)."""
    module = BCModule(tentry.build_flagship(**DIMS, device="cpu"), optimizer=OPT,
                      lr_scheduler=SCHED)
    before = ({n: p.detach().clone() for n, p in module.policy.named_parameters()},
              {n: b.clone() for n, b in module.policy.named_buffers()
               if n.endswith((".mean", ".var"))})
    shots = _snapshots(module)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=2,
                      accumulate_grad_batches=2, limit_train_batches=5,
                      check_val_every_n_epoch=0)
    np.random.seed(1)
    trainer.fit(module, _datamodule(False, files, str(tmp_path / "cache")))
    assert len(shots) == 10 and trainer.estimated_stepping_batches == 4
    assert module.scheduler.last_epoch == 5 and module.gradient_mean.mini_step == 0
    for i, (prev, now) in enumerate(zip([before] + shots, shots), start=1):
        assert all(not torch.equal(prev[1][n], now[1][n]) for n in now[1]), i
        same = [torch.equal(prev[0][n], now[0][n]) for n in now[0]]
        if i % 2:
            assert all(same), f"micro-step {i} moved a parameter"
        else:
            # most move; a zero bias with a zero gradient does not, nor does
            # a step at the schedule's floor (1e-8) move a weight of order 1
            assert sum(same) < len(same) / 4, f"micro-step {i} moved too few parameters"


class Stub(torch.nn.Module):
    """A policy of one weight and one running mean: loss mean((w q - 1)^2)
    over the batch's qpos, the mean of qpos folded in at every train-mode
    forward."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.register_buffer("mean", torch.zeros(3))

    def forward(self, batch, train=False, rngs=None):
        q = batch["qpos"]
        if train:
            self.mean.mul_(0.9).add_(0.1 * q.mean(0))
        loss = ((self.w * q - 1.0) ** 2).mean()
        return dict(batch, loss=loss, action_loss=loss, kl_loss=0.0 * loss)


class Rows:
    """``n`` samples of a fixed 3-wide qpos."""

    def __init__(self, n):
        self.qpos = np.random.RandomState(n).randn(n, 3).astype(np.float32)

    def __len__(self):
        return len(self.qpos)

    def __getitem__(self, i):
        return {"qpos": self.qpos[i]}


def _stub_fit(tmp_path, n=12, val=4, **kw):
    """A ``Trainer`` over ``Stub`` and ``Rows``: the trainer, the module,
    and the (global_step, limit_val_batches) of each validation."""
    module = BCModule(Stub(), optimizer=OPT, lr_scheduler=SCHED)
    calls, run = [], module.run_validation

    def spy(trainer, datamodule):
        calls.append((trainer.global_step, trainer.limit_val_batches))
        return run(trainer, datamodule)

    module.run_validation = spy
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", **kw)
    trainer.fit(module, _stub_data(n, Rows(val) if val else DummyDataset(4)))
    return trainer, module, calls


def _stub_data(n, val=None):
    return BaseDataModule(train=Rows(n), val=val, batch_size_train=2, pin_memory=False)


def test_k1_fit_equals_fit_steps(files, tmp_path):
    """k = 1: ``fit`` takes the same steps as ``fit_steps`` on the batches
    it drew, from the same generators (dropout on), bit for bit."""
    modules = [BCModule(tentry.build_flagship(**DIMS, device="cpu"), optimizer=OPT,
                        lr_scheduler=SCHED) for _ in range(2)]
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      limit_train_batches=3, check_val_every_n_epoch=0, seed=4)
    seen, step = [], trainer.train_step
    trainer.train_step = lambda m, b: (seen.append(b), step(m, b))[1]
    np.random.seed(2)
    trainer.fit(modules[0], _datamodule(False, files, str(tmp_path / "cache")))
    again = Trainer(seed=4)
    again.setup(modules[1], trainer.estimated_stepping_batches)
    again.fit_steps(modules[1], seen, len(seen))
    assert len(seen) == 3 and modules[0].gradient_mean is None
    for (name, a), b in zip(modules[0].policy.state_dict().items(),
                            modules[1].policy.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n, limit", [(10, None), (10, 1.0), (10, 0.25), (10, 0.01),
                                      (10, 0.0), (10, 3), (10, 30), (10, 0), (0, 0.5)])
def test_limit_matches_jax(n, limit):
    assert _limit(n, limit) == jlimit(n, limit)


@pytest.mark.parametrize("n_train, k, epochs", [(6, 2, 1), (5, 2, 2), (2, 3, 2), (7, 1, 1)])
def test_estimated_stepping_batches(tmp_path, n_train, k, epochs):
    """Optimizer steps: (batches // k) a epoch, at least 1, times the
    epochs; the schedule is built over them and stepped once each."""
    trainer, module, _ = _stub_fit(tmp_path, n=2 * n_train, max_epochs=epochs,
                                   accumulate_grad_batches=k, check_val_every_n_epoch=0)
    assert trainer.estimated_stepping_batches == max(1, n_train // k) * epochs
    assert trainer.global_step == n_train * epochs
    assert module.scheduler.last_epoch == (n_train * epochs) // k


def test_fast_dev_run(tmp_path):
    """One epoch, one training batch, one validation batch, no sanity
    check."""
    trainer, module, calls = _stub_fit(tmp_path, fast_dev_run=True, max_epochs=5,
                                       num_sanity_val_steps=2)
    assert (trainer.max_epochs, trainer.global_step) == (1, 1)
    assert calls == [(1, 1)]


@pytest.mark.parametrize("every, limit, want", [(2, 1.0, [4, 8]), (1, 1.0, [2, 4, 6, 8]),
                                                (0, 1.0, []), (1, 0, []), (3, 2, [6])])
def test_check_val_every_n_epoch(tmp_path, every, limit, want):
    trainer, module, calls = _stub_fit(tmp_path, n=4, max_epochs=4,
                                       check_val_every_n_epoch=every, limit_val_batches=limit)
    assert [step for step, _ in calls] == want


def test_sanity_check_runs_first_and_resets_the_trackers(tmp_path, caplog):
    """``num_sanity_val_steps`` batches of validation before any step, at
    that limit; then the limit is restored, and the trackers are reset so
    that the sanity values seed no best value."""
    trainer, module, calls = _stub_fit(tmp_path, max_epochs=1, num_sanity_val_steps=2,
                                       limit_val_batches=3, check_val_every_n_epoch=0)
    assert calls == [(0, 2)] and trainer.limit_val_batches == 3
    assert np.isnan(float(module.val_metrics.compute()["val/loss"]))
    assert float(module.best_val_metrics.compute()["val/loss_best"]) == float("inf")
    trainer, module, calls = _stub_fit(tmp_path, max_epochs=1, limit_val_batches=3)
    best = float(module.best_val_metrics.compute()["val/loss_best"])
    assert calls == [(6, 3)] and np.isfinite(best)


def test_validate_returns_the_held_out_loss(tmp_path):
    """``validate`` of a ``BCModule``: the mean loss over the validation
    batches, its best so far, logged."""
    module = BCModule(Stub(), optimizer=OPT)
    val = Rows(4)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", limit_val_batches=3,
                      logger=CSVLogger(str(tmp_path)))
    got = trainer.validate(module, _stub_data(6, val))
    want = float(np.mean(((val.qpos[:3] - 1.0) ** 2).mean(1)))
    assert got.keys() == {"val/loss", "val/loss_best"}
    np.testing.assert_allclose([got["val/loss"], got["val/loss_best"]], want, rtol=1e-6)
    assert float(_read_csv(tmp_path / "csv" / "metrics.csv")[0]["val/loss"]) == got["val/loss"]


def test_maniskill2_module_validates_to_nothing_on_a_dummy_dataset(tmp_path, caplog):
    """The flagship's task module, its configs' validation set (a
    ``DummyDataset``) and no simulator: the JAX module's warning and ``{}``,
    from ``fit`` too; an ``env_factory`` (rollouts) raises."""
    module = ManiSkill2ACTBCModule(Stub(), optimizer=OPT, lr_scheduler=SCHED,
                                   env_id="PickCube-v0")
    assert module.val_metric_keys == []
    assert isinstance(module.best_val_metrics.metrics[0], tmetrics.MaxMetric)
    dm = _stub_data(4, DummyDataset(size=400))
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1)
    with caplog.at_level(logging.WARNING):
        assert module.run_validation(trainer, dm) == {}
    assert "falling back to held-out-loss validation" in caplog.text
    rec = Record(lambda trainer, model: None)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      callbacks=[rec])
    trainer.fit(module, dm)
    assert rec.val == [{}]
    module.env_factory = lambda m: None
    with pytest.raises(NotImplementedError, match="item 12"):
        module.run_validation(trainer, dm)


def test_refit_logs_the_schedule_of_the_previous_fit(tmp_path):
    """The learning rate JAX logs: none in a module's first fit, and in a
    later one the schedule the module held when it began, at that fit's
    micro-step count (ROADMAP.md §3)."""
    trainer, module, _ = _stub_fit(tmp_path, n=8, max_epochs=1, accumulate_grad_batches=2,
                                   check_val_every_n_epoch=0, log_every_n_steps=1)
    first = module.scheduler
    trainer.logger = CSVLogger(str(tmp_path), name="again")
    trainer.fit(module, _stub_data(8))
    rows = [r for r in _read_csv(tmp_path / "again" / "metrics.csv") if r.get("lr")]
    assert [float(r["lr"]) for r in rows] == [first.lr_at(s) for s in range(1, 5)]


# ---------------------------------------------------------------------------
# metrics, and what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MeanMetric", "SumMetric", "MaxMetric", "MinMetric"])
@pytest.mark.parametrize("values", [[1.0, float("nan"), 4.0], [float("nan")], [],
                                    [-2.0, 3.0, float("nan"), 0.5]])
def test_metrics_match_jax(name, values):
    """Each accumulator against the JAX package's, weighted, NaN skipped;
    also after a reset and a second round."""
    got, ref = getattr(tmetrics, name)(), getattr(jmetrics, name)()
    for _ in range(2):
        for i, v in enumerate(values):
            got.update(torch.tensor(v), 1.0 + i)
            ref.update(v, 1.0 + i)
        np.testing.assert_allclose(float(got.compute()), ref.compute(), rtol=1e-12)
        got.reset()
        ref.reset()
        values = values[::-1]


def test_metrics_from_config_specs():
    built = tmetrics.Metrics([{"type": "MaxMetric"}, {"_target_": "x.MinMetric"}, {}],
                             ["a", "b", "c"], ["A", "B", "C"])
    assert [type(m).__name__ for m in built.metrics] == ["MaxMetric", "MinMetric",
                                                         "MeanMetric"]


def test_detect_anomaly_reads_the_loss(tmp_path):
    """Under ``detect_anomaly`` a non-finite loss stops the fit at its
    step; without it the step's loss is not read."""
    class Poisoned(Rows):
        def __getitem__(self, i):
            return {"qpos": self.qpos[i] * (np.nan if i == 5 else 1.0)}

    data = BaseDataModule(train=Poisoned(8), batch_size_train=2, pin_memory=False)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      detect_anomaly=True, check_val_every_n_epoch=0)
    with pytest.raises(FloatingPointError, match="non-finite loss nan at step"):
        trainer.fit(BCModule(Stub(), optimizer=OPT), data)
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=1,
                      check_val_every_n_epoch=0)
    trainer.fit(BCModule(Stub(), optimizer=OPT), data)
    assert trainer.global_step == 4


def test_what_is_not_ported_raises(tmp_path, monkeypatch):
    dm = _stub_data(4)
    for kw in ({"profiler": "simple"},):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Trainer(default_root_dir=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(default_root_dir=str(tmp_path), profiler="advanced")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for accelerator in ("tpu", "auto", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="no"):
            Trainer(default_root_dir=str(tmp_path), accelerator=accelerator).fit(
                BCModule(Stub(), optimizer=OPT), dm)
