"""The port's entry points as a user runs them: ``python -m
pointcloudmatters_tpu_torch.train`` and ``... .validate`` in subprocesses,
on the CPU (``trainer=cpu debug=default``: the exp config's
``accelerator: tpu``, which means the card, is overridden by the debug
overlay), over a synthetic demo file as ``tests/test_cli_e2e.py`` writes
one, at tiny widths. The flagship composition with two changes, as the card
run in ``chip_smoke.py`` makes them: held-out demos for validation and the
base task module, whose validation is the held-out loss
(``ManiSkill2ACTBCModule``'s needs the simulator), so that ``val/loss``
picks the top-k checkpoints.

A run writes ``checkpoints/last``, a top-k checkpoint and CSV metrics; a
second run from ``ckpt_path=<last>`` continues at the next epoch and step;
``validate ckpt_path=`` gives the held-out loss of the checkpoint; a ``-m``
sweep over two seeds writes two job directories.
"""

from __future__ import annotations

import ast
import csv
import os
import subprocess
import sys

import pytest
import torch

from pointcloudmatters_tpu_torch.trainer import read_checkpoint
from tests.synth import make_synthetic_maniskill2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_SIDE = 16
EPOCH_STEPS = 2  # debug=default: limit_train_batches 2


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_data")
    return tuple(make_synthetic_maniskill2(str(tmp / f"{name}.h5"), n_episodes=3, episode_len=6,
                                           cam_side=CAM_SIDE, seed=seed)
                 for name, seed in (("train", 0), ("val", 1)))


def _overrides(tmp_path, demos):
    train, val = demos
    cache = f"{tmp_path}/cache"
    return [
        "exp_maniskill2_act_policy=base",
        "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
        "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
        "trainer=cpu", "debug=default", "logger=csv",
        f"data.train.dataset_file={train}", f"data.train.point_num_per_cam={CAM_SIDE ** 2}",
        "data.train.chunk_size=5", f"data.train.cache_dir={cache}", "+data.train.loop=4",
        "data.batch_size_train=2", "data.pad_multiple=64",
        "model.policy.hidden_dim=32", "model.policy.pcd_npoints=16",
        "model.policy.pcd_nsample=4", "model.policy.transformer.num_encoder_layers=1",
        "model.policy.transformer.num_decoder_layers=1", "model.policy.transformer.nhead=4",
        # held-out demos and the base module: validation is the held-out loss
        "data.val._target_=pointcloudmatters_tpu.data.components.maniskill2."
        "ManiSkill2GoalPosSingleTaskACTPCDDataset",
        "~data.val.size", f"+data.val.dataset_file={val}", "+data.val.goal_cond_keys=[goal_pos]",
        "+data.val.chunk_size=5", f"+data.val.point_num_per_cam={CAM_SIDE ** 2}",
        f"+data.val.cache_dir={cache}", "+data.val.transform_pcd=${data.train.transform_pcd}",
        "model._target_=pointcloudmatters_tpu.models.bc_module.BCModule",
        "~model.val_metrics", "~model.best_val_metrics",
        "trainer.check_val_every_n_epoch=1", "callbacks.model_checkpoint.monitor=val/loss",
        "callbacks.model_checkpoint.mode=min", f"paths.log_dir={tmp_path}/logs",
    ]


def _run(module, args, timeout=300):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", f"pointcloudmatters_tpu_torch.{module}", *args],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


def _rows(run_dir):
    with open(os.path.join(run_dir, "csv", "metrics.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trained(demos, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_run")
    run = tmp / "run"
    _run("train", _overrides(tmp, demos) + [f"hydra.run.dir={run}", "trainer.max_epochs=2"])
    return tmp, run


def test_train_writes_checkpoints_and_metrics(trained):
    tmp, run = trained
    kept = sorted(os.listdir(run / "checkpoints"))
    assert "last" in kept
    assert {d for d in kept if d != "last"} <= {
        "epoch=000-val_mean_success=0", "epoch=001-val_mean_success=0"} and len(kept) >= 2
    last = read_checkpoint(str(run / "checkpoints" / "last"))
    assert (last["epoch"], last["step"]) == (1, 2 * EPOCH_STEPS)
    assert last["opt_state"]["scheduler"] == {"last_epoch": 2}
    rows = _rows(run)
    train_rows = [r for r in rows if r.get("train/loss")]
    assert [int(r["step"]) for r in train_rows] == [EPOCH_STEPS, 2 * EPOCH_STEPS]
    assert all(float(r["val/loss"]) > 0 for r in rows if r.get("val/loss"))
    assert len([r for r in rows if r.get("val/loss")]) == 2


def test_resume_continues_at_the_next_epoch(trained, demos):
    tmp, run = trained
    run2 = tmp / "run2"
    _run("train", _overrides(tmp, demos) + [
        f"hydra.run.dir={run2}", "trainer.max_epochs=3",
        f"ckpt_path={run / 'checkpoints' / 'last'}"])
    rows = [r for r in _rows(run2) if r.get("train/loss")]
    assert [int(r["step"]) for r in rows] == [3 * EPOCH_STEPS]
    last = read_checkpoint(str(run2 / "checkpoints" / "last"))
    assert (last["epoch"], last["step"]) == (2, 3 * EPOCH_STEPS)
    assert last["opt_state"]["scheduler"] == {"last_epoch": 3}
    before = read_checkpoint(str(run / "checkpoints" / "last"))
    assert any(not torch.equal(before["params"][k], last["params"][k]) for k in last["params"])


def test_validate_gives_the_held_out_loss_of_a_checkpoint(trained, demos):
    tmp, run = trained
    proc = _run("validate", _overrides(tmp, demos) + [
        f"hydra.run.dir={tmp / 'val'}", f"ckpt_path={run / 'checkpoints' / 'last'}"])
    line = next(ln for ln in proc.stdout.splitlines() if "Validation metrics:" in ln)
    metrics = ast.literal_eval(line.split("Validation metrics:", 1)[1].strip())
    assert set(metrics) == {"val/loss", "val/loss_best"}
    assert 0 < metrics["val/loss"] == metrics["val/loss_best"] < float("inf")
    with open(tmp / "val" / "csv" / "metrics.csv") as f:
        assert [float(r["val/loss"]) for r in csv.DictReader(f)] == [metrics["val/loss"]]


def test_multirun_writes_a_directory_a_job(demos, tmp_path):
    sweep = tmp_path / "sweep"
    _run("train", ["-m", "seed=1,2"] + _overrides(tmp_path, demos) + [
        f"hydra.sweep.dir={sweep}", "trainer.max_epochs=1"])
    for job in ("0", "1"):
        assert (sweep / job / "checkpoints" / "last" / "checkpoint.pt").is_file()
        assert _rows(sweep / job)
    a, b = (read_checkpoint(str(sweep / job / "checkpoints" / "last")) for job in ("0", "1"))
    assert any(not torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
