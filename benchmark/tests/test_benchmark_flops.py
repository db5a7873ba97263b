"""The yardstick's operation and byte counts: against hand counts, and
against ``torch.utils.flop_counter`` over the port's modules at tiny widths
(every point valid, so that the counted valid points are every slot)."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark import traffic as T
from benchmark.tests.conftest import ROOT, TINY


def test_hand_counts():
    assert flops.pointnet_macs(6) == 6 * 64 + 64 * 64 + 64 * 64 + 64 * 128 + 128 * 512 == 82304
    assert flops.pointnet_macs(6, 96) == 82304 + 512 * 96
    # forward 4 and backward 8 B H L^2 dh; 12 tensors of B H L dh read or written
    assert flops.attention_bound_s(1, 1, 1000, 100, "bf16") == pytest.approx(1.2e9 / 989e12)
    assert flops.attention_bound_s(1, 1, 1000, 100, "f32_product") == pytest.approx(1.2e9 / 165e12)
    assert flops.attention_bound_s(1, 1, 10, 100, "bf16") == pytest.approx(12 * 1000 * 2 / 3.35e12)
    # FPS: 8 operations a valid point a round; xyz, mask read, indices written
    assert flops.fps_bound_s(1000, 2000, 2, 100) == pytest.approx(8 * 1000 * 99 / 67e12)
    assert flops.fps_bound_s(1, 2000, 2, 2) == pytest.approx((2000 * 13 + 16) / 3.35e12)
    # kNN: 8 operations a (query, valid point of its cloud); queries, points read,
    # indices and squared distances written
    assert flops.knn_bound_s(100000, 200000, 2, 2048, 16) == pytest.approx(
        8 * 2048 * 100000 / 67e12)
    assert flops.knn_bound_s(1000, 2000, 2, 50, 4) == pytest.approx(
        ((2 * 50 + 2000) * 12 + 2000 + 2 * 50 * 4 * 8) / 3.35e12)
    assert flops.least_seconds({"bf16": 989e12, "f32_product": 165e12}) == pytest.approx(2.0)


def test_flagship_count():
    """ACTPCD at its published widths, B=32, every cloud full: the step's
    count by hand from the layer shapes."""
    cfg = harness.Bench(ROOT).config("act_pointnet_pcd")
    D, L, nq = 512, 2051, 100
    enc = 4 * L * D * D + 2 * L * L * D + 2 * L * D * 32
    dec = 4 * nq * D * D + 2 * nq * nq * D + 2 * nq * D * 32 + 2 * nq * D * D + 2 * L * D * D \
        + 2 * nq * L * D + nq * D * 8
    post = 4 * (4 * 102 * D * D + 2 * 102 * 102 * D + 2 * 102 * D * 32) + 100 * 7 * D + 9 * D \
        + D * 64
    per_sample = 4 * enc + dec + post + 32 * D + 2048 * 515 * D + 12 * D
    per_point = 82304 + 515 * 512
    want = 6 * (32 * per_sample + 32 * 10240 * per_point)
    assert flops.act_flops(cfg, 32, 32 * 10240, "bf16") == {"bf16": pytest.approx(want)}
    # ~190 GFLOP a sample at the traffic's mean of 7,680 valid points
    assert 180e9 < flops.act_flops(cfg, 1, 7680, "bf16")["bf16"] < 200e9


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _tiny(cell):
    bench = harness.Bench(ROOT)
    kind = {"act_pcd.train_b32_f32": "act", "dp_pcd.predict_b1": "dp_predict"}[cell]
    cfg, tr, bld = harness._setup_common(bench, cell, TINY[kind])
    policy = bld.make_policy(cfg, "cpu")
    harness.init_weights(policy, T.generator(0, "weights", "cpu"))
    return cfg, tr, bld, policy


def _full_clouds(tree):
    """Every slot of every cloud valid (the counters count valid points)."""
    if isinstance(tree, dict):
        return {k: (torch.ones_like(v) if k == "valid" else _full_clouds(v))
                for k, v in tree.items()}
    return tree


def test_act_counts_match_the_flop_counter():
    cfg, tr, bld, policy = _tiny("act_pcd.train_b32_f32")
    pool, _ = bld.make_pool(cfg, tr, T.generator(0, "data", "cpu"))
    batch = _full_clouds(pool[0])
    n = batch["pcds"]["valid"].numel()
    rngs = bld.ref_streams(0, "cpu")
    rngs["bits"], rngs["mask"] = rngs["dropout"], rngs["vae"]
    got_train = _counted(lambda: policy(batch, train=True, rngs=rngs))
    assert got_train == pytest.approx(flops.act_flops(cfg, 2, n, "f32")["f32_product"] / 3)
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    with torch.no_grad():
        got_serve = _counted(lambda: policy(obs, train=False))
    assert got_serve == pytest.approx(flops.act_flops(cfg, 2, n, "f32", train=False)["f32_product"])


def test_dp_counts_match_the_flop_counter():
    cfg, tr, bld, policy = _tiny("dp_pcd.predict_b1")
    tr = {**tr, "batch_size": 2, "states": 2 * tr["pool"]}
    reqs, data = bld.make_requests(cfg, tr, T.generator(0, "data", "cpu"))
    pcds = _full_clouds({k: torch.as_tensor(v) for k, v in reqs[0]["obs"]["pcds"].items()})
    n = int(pcds["valid"].sum())
    with torch.no_grad():
        enc = _counted(lambda: policy.obs_encoder(
            {"pcds": pcds, "qpos": torch.zeros(4, cfg["qpos_dim"])}, train=True))
        unet = _counted(lambda: policy.model(torch.zeros(2, cfg["horizon"], cfg["action_dim"]),
                                             3, global_cond=torch.zeros(
                                                 2, flops.unet_cond_dim(cfg))))
    assert enc == pytest.approx(2 * flops.dp_encoder_macs(cfg, 4, n))
    assert unet == pytest.approx(2 * flops.unet_macs(cfg, 2))
    step = flops.dp_step_flops(cfg, 2, n)
    assert step["bf16"] == pytest.approx(3 * enc) and step["f32_product"] == pytest.approx(3 * unet)
    req = flops.dp_request_flops(cfg, 2, n)["f32_product"]
    assert req == pytest.approx(enc + cfg["num_inference_steps"] * unet)
    n_params = sum(p.numel() for p in policy.model.parameters())
    assert flops.unet_call_bytes(n_params, cfg, 1) == 4 * (
        n_params + 2 * cfg["horizon"] * cfg["action_dim"] + flops.unet_cond_dim(cfg))
    assert math.isfinite(req)
