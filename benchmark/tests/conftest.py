"""Shared pieces of the benchmark's tests: tiny widths for the CPU, and the
``card`` marker for tests that need a CUDA card (they decide inside the
test, through the ``card`` fixture, and skip here)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at widths the CPU runs in seconds, their clouds from a 40 x 40
# camera; the ACT encoder keeps 515 rows, so that its long-row attention (and
# its Philox dropout mask) is exercised
SMALL_CAMERA = {"camera": {"side": 40}}
TINY = {
    "act": {"config": {"hidden_dim": 32, "nheads": 4, "enc_layers": 1, "dec_layers": 2,
                       "dim_feedforward": 16, "num_queries": 5, "pcd_npoints": 512,
                       "pcd_nsample": 4, "parameters": None},
            "traffic": {"batch_size": 2, "pool": 4, "states": 8, "padded_actions": 2,
                        "scene_overrides": SMALL_CAMERA}},
    "dp": {"config": {"pcd_npoints": 32, "pcd_nsample": 4, "pcd_feature_dim": 16,
                      "pcd_hidden_dim": 16, "projector_channels": [16, 24, 24],
                      "down_dims": [32, 64, 128], "diffusion_step_embed_dim": 16,
                      "num_inference_steps": 10, "num_train_timesteps": 10, "n_groups": 4,
                      "parameters": None},
           "traffic": {"batch_size": 4, "pool": 3, "states": 12, "normalizer_rows": 64,
                       "scene_overrides": SMALL_CAMERA}},
}
TINY["dp_predict"] = {"config": TINY["dp"]["config"],
                      "traffic": {"batch_size": 1, "pool": 4, "states": 4, "normalizer_rows": 64,
                                  "scene_overrides": SMALL_CAMERA}}
CELLS = {"act_pcd.train_b32": "act", "act_pcd.train_b32_f32": "act",
         "dp_pcd.train_b64": "dp", "dp_pcd.predict_b1": "dp_predict"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
