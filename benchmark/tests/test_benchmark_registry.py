"""The harness finds a cell, a configuration, a traffic mix and a metric by
name, and a new cell with a new metric is new files and new entries in
``BENCHMARK.json``: no file the benchmark has is edited."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import time
from types import SimpleNamespace

from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY


def test_names_resolve_to_files():
    bench = harness.Bench(ROOT)
    spec = bench.spec
    for w in spec["workloads"]:
        assert bench.cell(w["name"]) is w
        cfg = bench.config(w["config"])
        assert os.path.isfile(os.path.join(bench.dir, "adapters", cfg["adapter"] + ".py"))
        assert bench.traffic(w["traffic"])["mode"] in ("train", "predict")
        assert bench.metrics_of(w["name"], "end_to_end")
        assert bench.metrics_of(w["name"], "per_layer")
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
        for cell in m["workloads"]:  # every cell of a metric reports what it moves
            assert m["moves"] in [e["name"] for e in bench.metrics_of(cell, "end_to_end")]


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    # the new files: a traffic mix and a per-layer metric
    traffic = dict(harness.Bench(ROOT).traffic("train_b32_f32"), pool=3)
    (root / "benchmark" / "traffic" / "train_b2_f32.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "metrics" / "steps_run.train.py").write_text(
        "def read(ctx):\n    return ctx.units if ctx.mode == 'train' else None\n")
    # the new entries
    spec["workloads"].append({"name": "act_pcd.train_b2_f32", "config": "act_pointnet_pcd",
                              "traffic": "train_b2_f32", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("act_pcd.train_b2_f32")
    spec["per_layer"].append({"name": "steps_run.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "model step",
                              "moves": "train_samples_per_s",
                              "workloads": ["act_pcd.train_b2_f32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(str(root), str(root / "benchmark"))
    assert [m["name"] for m in bench.metrics_of("act_pcd.train_b2_f32", "per_layer")] == [
        "steps_run.train"]
    assert harness._read_metrics(bench, "act_pcd.train_b2_f32",
                                 SimpleNamespace(mode="train", units=7)) == {
        "steps_run.train": {"value": 7.0, "unit": "steps"}}
    result = harness.run_cell(str(root), "act_pcd.train_b2_f32", 3, 0.2, False, "cpu",
                              time.time(), TINY["act"], bench_dir=str(root / "benchmark"))
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert result["failed"] == 0 and set(result["checks"]) == {"loss_gap", "grad_gap",
                                                              "update_gap"}
    # no file of the benchmark was edited
    cmp = filecmp.dircmp(os.path.join(ROOT, "benchmark"), root / "benchmark",
                         ignore=["__pycache__"])
    assert not cmp.diff_files and not cmp.left_only
    assert sorted(cmp.right_only) == []
    assert not any(sub.diff_files for sub in cmp.subdirs.values())
