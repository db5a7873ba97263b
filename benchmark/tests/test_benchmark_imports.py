"""No run loads JAX or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), the reference loads nothing of
the port, and ``run.py`` refuses to run without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY

_ENV = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_ENV,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointcloudmatters_tpu_torch_extra", sys)
    assert "pointcloudmatters_tpu_torch_extra" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "pointcloudmatters_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"pointcloudmatters_tpu.ops", "jaxlib"} <= set(harness.forbidden_loaded())


@pytest.mark.parametrize("cell", ["act_pcd.train_b32", "dp_pcd.predict_b1"])
def test_a_run_loads_no_jax(cell):
    kind = "act" if cell.startswith("act") else "dp_predict"
    out = _python(
        "import json, sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        f"r = harness.run_cell('.', {cell!r}, 1, 0.1, False, 'cpu', time.time(), "
        f"{TINY[kind]!r})\n"
        "print(json.dumps([harness.forbidden_loaded(), "
        "'pointcloudmatters_tpu_torch' in sys.modules, r['attempted']]))\n")
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, port, attempted = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == [] and port and attempted >= 1


def test_the_reference_loads_nothing_of_the_port():
    out = _python(
        "import json, sys\n"
        "import benchmark.reference.act, benchmark.reference.dp, benchmark.reference.train\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"pointcloudmatters_tpu_torch", "pointcloudmatters_tpu", "jax", "jaxlib",
                       "flax", "optax"}


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "act_pcd.train_b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
