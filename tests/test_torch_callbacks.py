"""The port's callbacks (``pointcloudmatters_tpu_torch/callbacks.py``) and
loggers against the JAX package's: ``_format_filename`` on the shipped
patterns, ``ModelCheckpoint``'s top-k, ``save_last`` and ``rmtree`` of stale
checkpoints, ``EarlyStopping``'s patience and ``check_finite``, driven alike
on both sides; ``LearningRateMonitor`` logging the rate,
``DeviceStatsMonitor`` logging nothing on the CPU, ``ModelSummary``'s counts,
the progress line, SWA refusing; the offline back-end loggers writing what
JAX's write, and ``TensorBoardLogger`` writing CSV where ``SummaryWriter``
cannot be imported."""

import json
import logging
import math
import os
import sys

import pytest
import torch

from pointcloudmatters_tpu import callbacks as jcb
from pointcloudmatters_tpu.utils import loggers as jloggers
from pointcloudmatters_tpu_torch import callbacks as tcb
from pointcloudmatters_tpu_torch import loggers as tloggers
from pointcloudmatters_tpu_torch.entry import build_flagship
from pointcloudmatters_tpu_torch.models.bc_module import BCModule

PATTERNS = (
    "epoch_{epoch:03d}",  # configs/callbacks/default.yaml
    "epoch={epoch:03d}-val_mean_success={val/mean_success:.4f}",  # exp_maniskill2_*/base.yaml
    "epoch={epoch:03d}-val_loss={val/loss:.4f}",  # exp_rlbench_*/base.yaml
    "step={step}-{val/loss}",
)
METRICS = (
    {"epoch": 3, "val/mean_success": 0.5, "val/loss": 1.23456789, "step": 40},
    {"epoch": 12, "val/loss": float("nan"), "step": 7},
    {"epoch": 0, "val/mean_success": 1, "step": 0},
    {"epoch": 999, "val/loss": float("inf"), "val/mean_success": -0.25, "step": 123456},
)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("metrics", METRICS, ids=range(len(METRICS)))
def test_format_filename_matches_jax(pattern, metrics):
    for auto in (True, False):
        assert (tcb._format_filename(pattern, metrics, auto)
                == jcb._format_filename(pattern, metrics, auto))


class FakeTrainer:
    """What the callbacks read and call on a trainer; a checkpoint is a
    directory holding the step it was saved at."""

    def __init__(self, root):
        self.default_root_dir, self.global_step, self.should_stop = str(root), 0, False
        self.saved, self.logged, self.lr = [], [], None

    def save_checkpoint(self, path, weights_only=False):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "step"), "w") as f:
            f.write(str(self.global_step))
        self.saved.append((os.path.basename(path), weights_only))

    def log_metrics(self, metrics):
        self.logged.append((self.global_step, dict(metrics)))

    def current_lr(self):
        return self.lr


def _drive_checkpoint(pkg, root, kwargs, scores):
    cb = pkg.ModelCheckpoint(**kwargs)
    trainer = FakeTrainer(root)
    cb.setup(trainer, None)
    for epoch, score in enumerate(scores):
        trainer.global_step = 10 * (epoch + 1)
        metrics = {} if score is None else {"val/loss": score}
        cb.on_validation_end(trainer, None, metrics, epoch)
        cb.on_train_epoch_end(trainer, None, {"train/loss": 1.0, **metrics}, epoch)
    kept = sorted(os.listdir(cb.dirpath))
    steps = {d: open(os.path.join(cb.dirpath, d, "step")).read() for d in kept}
    return (trainer.saved, kept, steps, os.path.relpath(cb.best_model_path, root)
            if cb.best_model_path else "", cb.best_model_score,
            os.path.relpath(cb.last_model_path, root) if cb.last_model_path else "")


@pytest.mark.parametrize("kwargs", [
    dict(monitor="val/loss", mode="min", save_top_k=2, save_last=True,
         filename="epoch={epoch:03d}-val_loss={val/loss:.4f}", auto_insert_metric_name=False),
    dict(monitor="val/loss", mode="max", save_top_k=1, save_weights_only=True),
    dict(monitor="val/loss", mode="min", save_top_k=-1, every_n_epochs=2, save_last=True),
    dict(monitor=None, save_last=True),
    dict(monitor="val/loss", mode="min", save_top_k=3, dirpath="ckpts"),
], ids=["top2-last", "max-weights", "all-every2", "last-only", "dirpath"])
def test_model_checkpoint_matches_jax(kwargs, tmp_path):
    scores = [3.0, 1.0, None, 2.0, float("nan"), 0.5, 0.5, 4.0]
    results = []
    for pkg in (jcb, tcb):
        root = tmp_path / pkg.__name__
        kw = dict(kwargs)
        if "dirpath" in kw:
            kw["dirpath"] = str(root / kw["dirpath"])
        results.append(_drive_checkpoint(pkg, root, kw, scores))
    assert results[1] == results[0]
    saved, kept, *_ = results[1]
    assert saved and ("last" in kept) == bool(kwargs.get("save_last"))


@pytest.mark.parametrize("kwargs, scores", [
    (dict(monitor="val/loss", patience=2), [3.0, 2.0, 2.5, 2.1, 1.0]),
    (dict(monitor="val/loss", patience=1, min_delta=0.5), [3.0, 2.8, 1.0]),
    (dict(monitor="val/loss", mode="max", patience=2), [1.0, 2.0, 1.5, 1.9, 3.0]),
    (dict(monitor="val/loss", patience=5), [3.0, float("nan"), 1.0]),
    (dict(monitor="val/loss", patience=5, check_finite=False), [3.0, float("inf"), 1.0]),
    (dict(monitor="val/loss", patience=1), [None, None, 2.0]),
], ids=["patience", "min-delta", "max", "nan-stops", "unchecked", "missing"])
def test_early_stopping_matches_jax(kwargs, scores, tmp_path):
    stops = []
    for pkg in (jcb, tcb):
        cb, trainer, when = pkg.EarlyStopping(**kwargs), FakeTrainer(tmp_path), []
        for epoch, score in enumerate(scores):
            cb.on_validation_end(trainer, None, {} if score is None else {"val/loss": score},
                                 epoch)
            when.append((trainer.should_stop, cb.wait, cb.best))
        stops.append(when)
    assert repr(stops[1]) == repr(stops[0])


def test_early_stopping_patience_and_check_finite(tmp_path):
    trainer, cb = FakeTrainer(tmp_path), tcb.EarlyStopping(monitor="val/loss", patience=2)
    for epoch, score in enumerate([1.0, 1.5, 1.2]):
        cb.on_validation_end(trainer, None, {"val/loss": score}, epoch)
    assert trainer.should_stop and cb.wait == 2
    trainer, cb = FakeTrainer(tmp_path), tcb.EarlyStopping(monitor="val/loss", patience=9)
    cb.on_validation_end(trainer, None, {"val/loss": math.inf}, 0)
    assert trainer.should_stop


def test_learning_rate_monitor_logs_the_rate(tmp_path):
    trainer, cb = FakeTrainer(tmp_path), tcb.LearningRateMonitor(logging_interval="step")
    cb.on_train_epoch_end(trainer, None, {}, 0)
    assert trainer.logged == []  # no schedule: nothing, as in JAX
    trainer.lr, trainer.global_step = 2.5e-5, 8
    cb.on_train_epoch_end(trainer, None, {}, 1)
    assert trainer.logged == [(8, {"lr": 2.5e-5})]


def _tiny_module():
    return BCModule(build_flagship(hidden_dim=32, npoints=8, nsample=4, chunk=5, enc_layers=1,
                                   dec_layers=1, nhead=4, device="cpu"))


def test_device_stats_monitor_logs_nothing_on_the_cpu(tmp_path):
    trainer = FakeTrainer(tmp_path)
    tcb.DeviceStatsMonitor().on_train_epoch_end(trainer, _tiny_module(), {}, 0)
    assert trainer.logged == []


def test_model_summary_counts_parameters(tmp_path, caplog):
    module = _tiny_module()
    with caplog.at_level(logging.INFO):
        tcb.ModelSummary(max_depth=-1).on_fit_start(FakeTrainer(tmp_path), module)
    total = sum(p.numel() for p in module.policy.parameters())
    assert f"Model parameters: {total:,}" in caplog.text
    backbone = sum(p.numel() for p in module.policy.backbone.parameters())
    assert f"backbone: {backbone:,}" in caplog.text
    assert f"query_embed: {module.policy.query_embed.numel():,}" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        tcb.ModelSummary(max_depth=0).on_fit_start(FakeTrainer(tmp_path), module)
    assert "backbone" not in caplog.text


def test_progress_bar_logs_the_epoch(tmp_path, caplog):
    assert tcb.ProgressBar is tcb.RichProgressBar
    with caplog.at_level(logging.INFO):
        tcb.RichProgressBar(refresh_rate=5).on_train_epoch_end(
            FakeTrainer(tmp_path), None, {"train/loss": 0.123456, "val/loss": 2.0}, 4)
    assert "epoch 4: train/loss=0.12346 val/loss=2" in caplog.text


def test_stochastic_weight_averaging_is_not_ported():
    """Ported (``tests/test_torch_swa.py`` holds it against JAX): it takes
    the JAX callback's keys, the first of a list of rates, and refuses an
    unknown anneal as JAX does."""
    swa = tcb.StochasticWeightAveraging(swa_lrs=[1e-3, 2e-3], device="cuda")
    assert (swa.swa_lrs, swa.swa_epoch_start, swa.annealing_epochs, swa.n_averaged) == (
        1e-3, 0.8, 10, 0)
    with pytest.raises(ValueError, match="annealing_strategy"):
        tcb.StochasticWeightAveraging(swa_lrs=1e-3, annealing_strategy="exp")


@pytest.mark.parametrize("name, kwargs", [
    ("WandbLogger", {"save_dir": "TMP", "offline": True, "project": "p", "tags": []}),
    ("CometLogger", {"project_name": "p"}),
    ("MLFlowLogger", {"tracking_uri": "TMP/mlflow/mlruns", "tags": None}),
    ("MLFlowLogger", {"tracking_uri": "file:TMP/mlruns"}),
    ("MLFlowLogger", {"tracking_uri": "http://tracking.invalid:5000"}),
    ("NeptuneLogger", {"save_dir": "TMP", "api_key": None}),
    ("AimLogger", {"save_dir": "TMP", "repo": "x"}),
])
def test_offline_loggers_match_jax(name, kwargs, tmp_path, monkeypatch):
    """Where each writes (relative to its own directory, ``TMP``, or the
    working directory), the recorded back-end config and the metrics."""
    out = []
    for pkg, sub in ((jloggers, "jax"), (tloggers, "torch")):
        root = tmp_path / sub
        root.mkdir()
        monkeypatch.chdir(root)
        kw = {k: (v.replace("TMP", str(root)) if isinstance(v, str) else v)
              for k, v in kwargs.items()}
        lg = getattr(pkg, name)(**kw)
        lg.log_metrics({"train/loss": 1.5}, 3)
        with open(os.path.join(lg.save_dir, "backend_config.json")) as f:
            config = f.read().replace(str(root), "TMP")
        with open(lg.path) as f:
            rows = f.read()
        out.append((os.path.relpath(os.path.abspath(lg.save_dir), root), config, rows))
    assert out[1] == out[0]


def test_tensorboard_logger_writes_csv_without_a_summary_writer(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = tloggers.TensorBoardLogger(save_dir=str(tmp_path), name="tb", prefix="p/")
    assert lg.writer == "csv" and lg.save_dir == str(tmp_path / "tb")
    lg.log_metrics({"loss": torch.tensor(2.0)}, 5)
    lg.log_hyperparams({"seed": 1})
    lg.finalize()
    with open(tmp_path / "tb" / "metrics.csv") as f:
        assert f.read().splitlines() == ["step,loss", "5,2.0"]
    assert json.loads((tmp_path / "tb" / "hparams.json").read_text()) == {"seed": 1}
