"""The port's ``StochasticWeightAveraging`` (``pointcloudmatters_tpu_torch/
callbacks.py``) against the JAX callback, on the CPU.

- The composition of the JAX package's own SWA test
  (``tests/test_training.py::TestStochasticWeightAveraging``: the tiny
  flagship from ``configs/`` with ``callbacks=stochastic_weight_averaging``,
  ``swa_lrs`` 5e-4, ``swa_epoch_start`` 0.5, ``annealing_epochs`` 1, 4
  epochs of 2 micro-batches), trained by both packages on the same data
  from the same initial weights, with ``"32-true"``, dropout 0 and one
  numpy draw of the posterior noise, so that the trajectories compare.
  Held: ``n_averaged``; the wrapped learning rate at every step and as the
  CSV logger logs it (rtol 1e-6: both schedules run in f32); the average
  of the same epoch-end snapshots (JAX's, converted) within 1e-6; the
  batch-norm refresh on the same batches with the same averaged weights
  within 1e-5 of each statistic's largest entry (JAX recovers the
  per-batch statistics by dividing a probe by ``1 - momentum``, the port
  reads them directly); and the fits' averaged weights within the limits
  of ``tests/test_torch_fit.py`` (f32 summation order over 4 AdamW steps).
- Each normaliser the port has (``MaskedBatchNorm`` with a mask and its
  unbiased running variance, ``GroupedBNReluMax`` counting hole rows,
  SpUNet's three-branch ``PDBatchNorm``, a ResNet block's batch norms)
  refreshed by both callbacks over the same batches, within 1e-5 of
  max|stat|.
- The schedule's edge cases against JAX's ``_swa_schedule`` (no base
  schedule: ``swa_lrs`` throughout; the linear anneal; an epoch given as an
  int), ``avg_fn``, and that epoch-end checkpoints keep the weights that
  were not averaged.
"""

import csv
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn_linen

from pointcloudmatters_tpu import callbacks as jcb
from pointcloudmatters_tpu.models.components import nn_utils as jnn
from pointcloudmatters_tpu.models.components import pretrained as jpretrained
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.img_encoder import resnet as jresnet
from pointcloudmatters_tpu.models.components.pcd_encoder import spunet as jspunet
from pointcloudmatters_tpu.utils import config as JC
from pointcloudmatters_tpu.utils import utils as jutils
from pointcloudmatters_tpu_torch import callbacks as tcb
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet as tresnet
from pointcloudmatters_tpu_torch.models.components.pcd_encoder import spunet as tspunet
from pointcloudmatters_tpu_torch.trainer import Trainer, read_checkpoint
from pointcloudmatters_tpu_torch.utils import config as TC
from pointcloudmatters_tpu_torch.utils import utils as tutils
from pointcloudmatters_tpu_torch.utils.flax_to_torch import _unkey, flax_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_fit import Stub, _stub_data
from test_torch_training import _ZERO_GRAD
from tests.synth import make_synthetic_maniskill2

CONFIG_DIR = str(pathlib.Path(__file__).resolve().parent.parent / "configs")
CAM_SIDE = 16
SWA_LRS = 5e-4
STAT_TOL = 1e-5  # of max|stat|: the JAX probe's division by 1 - momentum


def _overrides(data_file, root, name):
    return [
        "exp_maniskill2_act_policy=base",
        "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
        "debug=default",
        f"data.train.dataset_file={data_file}",
        f"data.train.point_num_per_cam={CAM_SIDE * CAM_SIDE}",
        "data.train.chunk_size=5",
        f"data.train.cache_dir={root}/{name}_cache",
        "data.batch_size_train=2",
        "data.pad_multiple=64",
        "model.policy.hidden_dim=32",
        "model.policy.pcd_npoints=16",
        "model.policy.pcd_nsample=4",
        "model.policy.transformer.num_encoder_layers=1",
        "model.policy.transformer.num_decoder_layers=1",
        "model.policy.transformer.nhead=4",
        "model.policy.transformer.dropout=0.0",
        "logger=csv",
        "trainer.log_every_n_steps=1",
        "trainer.precision=32-true",
        "callbacks=stochastic_weight_averaging",
        f"callbacks.stochastic_weight_averaging.swa_lrs={SWA_LRS}",
        "callbacks.stochastic_weight_averaging.swa_epoch_start=0.5",
        "callbacks.stochastic_weight_averaging.annealing_epochs=1",
        "trainer.max_epochs=4",
        "trainer.limit_train_batches=2",
        "trainer.check_val_every_n_epoch=0",
        "trainer.num_sanity_val_steps=0",
        f"hydra.run.dir={root}/{name}",
    ]


def _compose(engine, data_file, root, name):
    cfg = engine.compose(CONFIG_DIR, "train", _overrides(data_file, root, name))
    engine.set_runtime(output_dir=str(root / name), cwd=str(root))
    return engine.resolve_config(cfg)


class Snapshots:
    """The JAX side's epoch-end parameters, and numpy's global state when
    the fit ends (before the SWA callback's refresh draws its batches)."""

    def __init__(self):
        self.params, self.np_state = [], None

    def setup(self, trainer, module):
        pass

    def on_fit_start(self, trainer, module):
        pass

    def on_validation_end(self, trainer, module, metrics, epoch):
        pass

    def on_train_epoch_end(self, trainer, module, metrics, epoch):
        self.params.append(jax.tree.map(np.asarray, trainer.state.params))

    def on_fit_end(self, trainer, module):
        self.np_state = np.random.get_state()


def _rows(root, name):
    with open(root / name / "csv" / "metrics.csv") as f:
        return [r for r in csv.DictReader(f) if r.get("lr")]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("swa")
    data_file = make_synthetic_maniskill2(str(root / "traj.h5"), n_episodes=4, episode_len=6,
                                          cam_side=CAM_SIDE)
    eps = np.random.RandomState(3).randn(2, 32).astype(np.float32)
    initial = {}

    def capture(policy, variables):
        initial.update(jax.tree.map(np.asarray, variables))
        return variables

    mp = pytest.MonkeyPatch()
    mp.setenv("PROJECT_ROOT", str(root))
    mp.setattr(jpretrained, "load_pretrained_into", capture)
    mp.setattr(jact, "reparametrize",
               lambda mu, logvar, key: mu + jnp.exp(0.5 * logvar) * eps[:len(mu)])
    mp.setattr(tact, "reparametrize", lambda mu, logvar, gen: (
        mu + torch.exp(0.5 * logvar) * torch.from_numpy(eps[:len(mu)])))
    try:
        with jax.default_prng_impl("threefry2x32"):
            cfg = _compose(JC, data_file, root, "jax")
            jdm, jmodel = JC.instantiate(cfg.data), JC.instantiate(cfg.model)
            snaps = Snapshots()
            jcallbacks = [snaps] + jutils.instantiate_callbacks(cfg.get("callbacks"))
            jtrainer = JC.instantiate(cfg.trainer, callbacks=jcallbacks,
                                      logger=jutils.instantiate_loggers(cfg.get("logger")))
            np.random.seed(0)
            jtrainer.fit(jmodel, datamodule=jdm)

        cfg = _compose(TC, data_file, root, "torch")
        dm, module = TC.instantiate(cfg.data), TC.instantiate(cfg.model)
        module.load_variables(initial)
        callbacks = tutils.instantiate_callbacks(cfg.get("callbacks"))
        trainer = TC.instantiate(cfg.trainer, callbacks=callbacks,
                                 logger=tutils.instantiate_loggers(cfg.get("logger")))
        np.random.seed(0)
        trainer.fit(module, datamodule=dm)
    finally:
        mp.undo()
    final = {k: v.detach().clone() for k, v in module.policy.named_parameters()}
    return dict(root=root, jtrainer=jtrainer, jswa=jcallbacks[-1], snaps=snaps,
                trainer=trainer, swa=callbacks[-1], module=module, dm=dm, final=final)


def test_swa_from_configs_averages_and_anneals_as_jax(fits):
    jtrainer, jswa, trainer, swa = fits["jtrainer"], fits["jswa"], fits["trainer"], fits["swa"]
    assert isinstance(swa, tcb.StochasticWeightAveraging)
    assert swa.n_averaged == jswa.n_averaged == 2
    total = trainer.estimated_stepping_batches
    assert total == jtrainer.estimated_stepping_batches == 4
    got = [trainer._schedule.lr_at(s) for s in range(total + 2)]
    ref = [float(jtrainer._schedule(s)) for s in range(total + 2)]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[total], SWA_LRS, rtol=1e-6)
    rows, jrows = _rows(fits["root"], "torch"), _rows(fits["root"], "jax")
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [
        str(s) for s in range(1, 2 * total + 1)]
    np.testing.assert_allclose([float(r["lr"]) for r in rows],
                               [float(r["lr"]) for r in jrows], rtol=1e-6, atol=0)


def test_the_average_of_the_same_snapshots_equals_jax(fits):
    module, jswa = fits["module"], fits["jswa"]
    swa = tcb.StochasticWeightAveraging(swa_lrs=SWA_LRS, swa_epoch_start=0.5)
    swa._swa_start_epoch = 2
    with torch.no_grad():
        for epoch, params in enumerate(fits["snaps"].params):
            for name, p in _params_only(params, module.policy).items():
                module.policy.get_parameter(name).copy_(p)
            swa.on_train_epoch_end(fits["trainer"], module, {}, epoch)
    assert swa.n_averaged == 2
    for name, r in _params_only(jswa._avg, module.policy).items():
        np.testing.assert_allclose(swa._avg[name].numpy(), r.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def _params_only(params, policy):
    """JAX params -> the port's parameter tensors by name (the statistics
    the conversion needs are the policy's own)."""
    names = dict(policy.named_parameters())
    stats: dict = {}
    for k, v in policy.state_dict().items():
        if k in names:
            continue
        *path, leaf = _unkey(k).split(".")
        node = stats
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.numpy()
    full = flax_to_torch({"params": params, "batch_stats": stats}, policy)
    return {k: v for k, v in full.items() if k in names}


def test_the_refresh_on_the_same_batches_equals_jax(fits):
    """The port's refresh with JAX's averaged weights over the batches the
    JAX refresh drew (numpy's state at the JAX fit's end, a loader at its
    epoch 0, as both callbacks take a new one)."""
    module, trainer, jtrainer = fits["module"], fits["trainer"], fits["jtrainer"]
    policy = module.policy
    policy.load_state_dict({**policy.state_dict(), **_params_only(fits["jswa"]._avg, policy)},
                           strict=True)
    np.random.set_state(fits["snaps"].np_state)
    fresh = tcb.StochasticWeightAveraging(swa_lrs=SWA_LRS).refresh_batch_stats(trainer, module)
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, jtrainer.state.params),
                         "batch_stats": jax.tree.map(np.asarray, jtrainer.state.batch_stats)},
                        policy)
    assert set(fresh) == set(ref) - set(dict(policy.named_parameters()))
    for name, got in fresh.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(got.numpy(), r, atol=STAT_TOL * np.abs(r).max(), rtol=0,
                                   err_msg=name)


def test_the_fits_end_on_averaged_weights_within_the_fit_limits(fits):
    module, jtrainer, swa = fits["module"], fits["jtrainer"], fits["swa"]
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, jtrainer.state.params),
                         "batch_stats": jax.tree.map(np.asarray, jtrainer.state.batch_stats)},
                        module.policy)
    lr_sum = sum(fits["trainer"]._schedule.lr_at(s) for s in range(4))
    for name, p in fits["final"].items():
        assert torch.equal(p, swa._avg[name]), name
        r = ref[name].numpy()
        atol = 4.0 * lr_sum if any(k in name for k in _ZERO_GRAD) else \
            2e-6 + 1e-4 * np.abs(r).max()
        np.testing.assert_allclose(p.numpy(), r, atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# every normaliser: the refresh against JAX's probe
# ---------------------------------------------------------------------------

B, N, M, K, C = 3, 24, 8, 4, 6


class JNorms(jnn_linen.Module):
    """Each normaliser of the JAX package once, in train mode."""

    @jnn_linen.compact
    def __call__(self, batch, train=True):
        pcds = batch["pcds"]
        x, valid, idx = pcds["feat"], pcds["valid"], pcds["grid_coord"]
        a = jnn.MaskedBatchNorm(name="masked")(x, mask=valid, use_running_average=not train)
        h = jnn_linen.Dense(C, name="proj")(x[:, :M])
        g = jnn.GroupedBNReluMax(name="grouped")(a, h, idx, use_running_average=not train)
        p = jspunet.PDBatchNorm(name="pd")(x, mask=valid, condition="S3DIS", train=train)
        img = batch["image"]
        r = jresnet.BasicBlock(features=C, name="block")(img, train=train)
        return {"loss": g.sum() + p.sum() + r.sum()}


class TNorms(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.masked = tnn.MaskedBatchNorm(C)
        self.proj = torch.nn.Linear(C, C)
        self.grouped = tnn.GroupedBNReluMax(C)
        self.pd = tspunet.PDBatchNorm(C)
        self.block = tresnet.BasicBlock(C, C)

    def forward(self, batch, train=True, rngs=None):
        pcds = batch["pcds"]
        x, valid, idx = pcds["feat"], pcds["valid"], pcds["grid_coord"]
        a = self.masked(x, mask=valid, use_running_average=not train)
        g = self.grouped(a, self.proj(x[:, :M]), idx, use_running_average=not train)
        p = self.pd(x, mask=valid, condition="S3DIS", train=train)
        r = self.block(batch["image"], train=train)
        return {"loss": g.sum() + p.sum() + r.sum()}


def _norm_batches(n):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
        idx[0, :3, 2:] = -1  # holes count in the grouped statistics
        # under keys that select_model_batch keeps
        out.append({"pcds": {"feat": (rng.randn(B, N, C) * 2 + 0.5).astype(np.float32),
                             "valid": np.arange(N)[None] < np.array([[N], [17], [9]]),
                             "grid_coord": idx},
                    "image": rng.randn(B, 5, 5, C).astype(np.float32)})
    return out


class _Loader(list):
    pass


class _DM:
    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self):
        return _Loader(self.batches)


@pytest.mark.parametrize("steps", [-1, 2])
def test_every_normaliser_refreshes_as_jax(steps):
    batches = _norm_batches(3)
    jm = JNorms()
    jb = jax.tree.map(jnp.asarray, batches[0])
    variables = jm.init(jax.random.PRNGKey(0), jb)

    class JModule:
        def apply_train(self, v, batch, rngs):
            return jm.apply(v, batch, train=True, rngs=rngs, mutable=["batch_stats"])

        def make_rngs(self, key):
            return {}

    class JTrainer:
        datamodule = _DM(batches)

        class state:
            batch_stats = variables["batch_stats"]

        @staticmethod
        def shard_batch(batch):
            return jax.tree.map(jnp.asarray, batch)

    jswa = jcb.StochasticWeightAveraging(swa_lrs=0.1, bn_update_steps=steps)
    ref = jswa._refresh_batch_stats(JTrainer, JModule(), variables["params"])

    tm = TNorms()
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    with torch.no_grad():  # the refresh must not read the statistics it replaces
        for b in tm.buffers():
            b.fill_(3.0)
    module = BCModule(tm, device="cpu")
    trainer = Trainer(accelerator="cpu")
    trainer.datamodule = _DM(batches)
    got = tcb.StochasticWeightAveraging(swa_lrs=0.1, bn_update_steps=steps).refresh_batch_stats(
        trainer, module)
    want = flax_to_torch({"params": variables["params"],
                          "batch_stats": jax.tree.map(np.asarray, ref)}, tm)
    assert set(got) == {k for k, _ in tm.named_buffers()}
    for name, g in got.items():
        r = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=STAT_TOL * np.abs(r).max(), rtol=0,
                                   err_msg=name)
    assert all(m.momentum != 1.0 for m in tm.modules() if isinstance(m, tnn._RunningNorm))


# ---------------------------------------------------------------------------
# the schedule's cases, avg_fn, checkpoints
# ---------------------------------------------------------------------------

def _base(step):
    return 1e-3 * (1.0 - 0.05 * float(step))


@pytest.mark.parametrize("strategy", ["cos", "linear"])
@pytest.mark.parametrize("base", [None, _base])
def test_schedule_matches_jax(strategy, base):
    """Without a base schedule the rate is ``swa_lrs`` from step 0 (JAX's
    choice, where Lightning keeps the optimizer's rate until the start)."""
    kw = dict(swa_lrs=[2e-4], annealing_strategy=strategy)
    got = tcb.StochasticWeightAveraging(**kw).swa_schedule(base, 6.0, 3.0)
    jbase = None if base is None else (lambda s: jnp.float32(1e-3) * (1.0 - 0.05 * s))
    ref = jcb.StochasticWeightAveraging(**kw)._swa_schedule(jbase, 6.0, 3.0)
    steps = range(14)
    np.testing.assert_allclose([got(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=0)
    if base is None:
        assert all(got(s) == np.float32(2e-4) for s in steps)


def test_start_epoch_forms_and_bad_strategy():
    class T:
        max_epochs, estimated_stepping_batches = 10, 20
        gradient_clip_val, accumulate_grad_batches = None, 1

    for start, want in ((0.5, 5), (3, 3), (3.0, 3), (1.0, 1)):
        module = BCModule(torch.nn.Linear(2, 2), device="cpu",
                          lr_scheduler={"scheduler": {"type": "CosineAnnealingLR"}})
        swa = tcb.StochasticWeightAveraging(swa_lrs=1e-2, swa_epoch_start=start,
                                            annealing_epochs=1)
        swa.setup(T(), module)
        assert swa._swa_start_epoch == want
        assert module.scheduler.lr_at(2 * want + 2) == pytest.approx(1e-2)
    with pytest.raises(ValueError, match="annealing_strategy"):
        tcb.StochasticWeightAveraging(swa_lrs=1e-2, annealing_strategy="step")


def test_avg_fn_and_checkpoints_keep_the_weights_not_averaged(tmp_path):
    seen = []

    def avg_fn(a, p, n):
        seen.append(n)
        return a + (p - a) / (n + 1.0)

    snaps = []

    class Keep(tcb.Callback):
        def on_train_epoch_end(self, trainer, module, metrics, epoch):
            snaps.append({k: v.detach().clone() for k, v in module.policy.named_parameters()})

    swa = tcb.StochasticWeightAveraging(swa_lrs=1e-2, swa_epoch_start=1, avg_fn=avg_fn)
    ckpt = tcb.ModelCheckpoint(dirpath=str(tmp_path / "ckpt"), save_last=True)
    module = BCModule(Stub(), device="cpu", optimizer={"type": "SGD", "lr": 0.1})
    trainer = Trainer(default_root_dir=str(tmp_path), accelerator="cpu", max_epochs=3,
                      callbacks=[Keep(), ckpt, swa], log_every_n_steps=1)
    trainer.fit(module, _stub_data(4))
    assert swa.n_averaged == 2 and seen == [1]
    last = read_checkpoint(ckpt.last_model_path)["params"]
    for name, p in module.policy.named_parameters():
        mean = snaps[1][name] + (snaps[2][name] - snaps[1][name]) / 2.0
        torch.testing.assert_close(p.detach(), mean, rtol=0, atol=0)
        assert torch.equal(last[name], snaps[2][name])
    # no scheduler: every optimizer step ran at swa_lrs
    assert module.optimizer.param_groups[0]["lr"] == pytest.approx(1e-2)
