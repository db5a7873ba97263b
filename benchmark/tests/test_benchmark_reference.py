"""The plain reference against the port at tiny widths on the CPU, the
control one precision below, and the faults a run has to catch: each run
drives the harness end to end but for the look for a card."""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, ROOT, TINY

SEED = 2**31 + 12345
# the port against the reference at tiny widths on the CPU: f32 to round-off
# (the Adam update amplifies it where a gradient is near zero); bf16 to a few
# of its ulps carried through the step; the serving chain bit for bit
TOLERANCE = {
    "act_pcd.train_b32_f32": {"loss_gap": 1e-6, "grad_gap": 1e-5, "update_gap": 1e-3},
    "act_pcd.train_b32": {"loss_gap": 1e-2, "grad_gap": 0.03, "update_gap": 0.1},
    "dp_pcd.train_b64": {"loss_gap": 1e-2, "grad_gap": 0.15, "update_gap": 0.15},
    "dp_pcd.predict_b1": {"action_gap": 1e-6},
}


def _run(cell, hooks=None, seed=SEED):
    return harness.run_cell(ROOT, cell, seed, 0.2, False, "cpu", time.time(),
                            TINY[CELLS[cell]], hooks)


@pytest.mark.parametrize("cell", sorted(TOLERANCE))
def test_reference_follows_the_port(cell):
    result = _run(cell)
    assert result["failed"] == 0 and result["attempted"] >= 1
    for name, check in result["checks"].items():
        assert check["value"] <= TOLERANCE[cell][name], (name, check)
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["act_pcd.train_b32", "dp_pcd.train_b64"])
def test_float8_control_reads_far_above_the_port(cell):
    sound = {k: c["value"] for k, c in _run(cell)["checks"].items()}
    control = harness.reference_pair(ROOT, cell, SEED, "cpu", "control", TINY[CELLS[cell]])
    assert max(control[k] / max(sound[k], 1e-12) for k in sound) >= 3.0, (sound, control)


@pytest.mark.parametrize("cell", ["act_pcd.train_b32", "dp_pcd.train_b64"])
def test_float8_control_is_not_correct(cell):
    """The control in the program's place, through the whole run: its
    numbers against the cell's own limits read ``correct`` false."""
    result = _run(cell, {"control": True})
    assert result["correct"] is False, result["checks"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


# TF32 exists only on the card. The f32 training cell runs there at its own
# size: at tiny widths its products sum too few terms for TF32's rounding to
# pass limits set at the cell's widths.
CARD_SIZES = {"act_pcd.train_b32_f32": {}, "dp_pcd.predict_b1": TINY["dp_predict"]}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CARD_SIZES))
def test_tf32_control_fails_a_limit(card, cell):
    """The TF32 control in the program's place through the whole run, and
    beside the reference alone."""
    result = harness.run_cell(ROOT, cell, SEED, 0.2, False, card, time.time(),
                              CARD_SIZES[cell], {"control": True})
    assert result["correct"] is False, result["checks"]
    limits = harness.Bench(ROOT).traffic(harness.Bench(ROOT).cell(cell)["traffic"])["limits"]
    control = harness.reference_pair(ROOT, cell, SEED, card, "control", CARD_SIZES[cell])
    assert any(control[k] > limits[k] for k in limits), control


# the faults a cell can have, planted under the timed path
def _state_unchanged(module, trainer):
    module.optimizer.step = lambda *a, **k: None


def _half_batch(module, trainer):
    step = trainer.train_step
    trainer.train_step = lambda m, batch: step(m, harness._half(batch))


@pytest.mark.parametrize("cell", ["act_pcd.train_b32", "act_pcd.train_b32_f32",
                                  "dp_pcd.train_b64"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_step_is_not_correct(cell, fault):
    result = _run(cell, {"program": fault})
    assert result["correct"] is False
    failing = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    if fault is _state_unchanged:
        assert "update_gap" in failing and result["checks"]["update_gap"]["value"] == 1.0
    else:
        assert failing


def test_an_altered_answer_is_not_correct():
    cell = "dp_pcd.predict_b1"
    bld = harness.Bench(ROOT).adapter(harness.Bench(ROOT).config("dp_pointnet_pcd"))

    def altered(module, obs, gen):
        out = bld.predict(module, obs, gen)
        out[..., 0, 0] += 0.05 * np.abs(out).max()
        return out

    result = _run(cell, {"predict": altered})
    assert result["correct"] is False
    assert result["checks"]["action_gap"]["value"] >= 0.04
