"""The traffic generator: one seed gives the same arrays, two seeds differ
in the arrays but not in the work (the same clouds' counts and the same
batch shapes)."""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark import traffic as T
from benchmark.tests.conftest import ROOT, TINY


def _pool(cell, seed):
    bench = harness.Bench(ROOT)
    cfg, tr, bld = harness._setup_common(bench, cell, TINY[
        "act" if cell.startswith("act") else "dp"])
    return bld.make_pool(cfg, tr, T.generator(seed, "data", "cpu"))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def _equal(a, b):
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def test_same_seed_same_traffic_other_seed_other_arrays():
    for cell in ("act_pcd.train_b32", "dp_pcd.train_b64"):
        (a, da), (b, db), (c, _) = _pool(cell, 2**31 + 7), _pool(cell, 2**31 + 7), _pool(cell, 5)
        assert all(_equal(x, y) for x, y in zip(a, b))
        assert all((da[k] == db[k]).all() for k in da)
        assert not any(_equal(x, y) for x, y in zip(a, c))


def test_every_seed_the_same_valid_counts():
    def counts(cell, seed):
        pool, _ = _pool(cell, seed)
        clouds = [b["pcds"] if "pcds" in b else b["obs"]["pcds"] for b in pool]
        return [(p["valid"].shape, p["valid"].sum(1).tolist()) for p in clouds]
    for cell in ("act_pcd.train_b32", "dp_pcd.train_b64"):
        assert counts(cell, 1) == counts(cell, 2**31 + 99)


def test_clouds_valid_first_in_morton_order_padded_as_the_collate():
    pool, _ = _pool("act_pcd.train_b32", 11)
    for batch in pool:
        pcds = batch["pcds"]
        valid = pcds["valid"]
        n = valid.sum(1)
        assert valid.shape[1] % 512 == 0 and valid.shape[1] - 512 < int(n.max())
        for c in range(valid.shape[0]):
            assert valid[c, :n[c]].all() and not valid[c, n[c]:].any()
            xyz = pcds["coord"][c, :n[c]][None]
            order = T.morton_order(xyz, torch.ones(xyz.shape[:2], dtype=torch.bool))
            assert torch.equal(order[0], torch.arange(int(n[c])))
            assert (pcds["coord"][c, n[c]:] == 0).all()
            assert (pcds["coord"][c, :n[c], 2] > 0.005).all()  # the ground is dropped
        assert torch.equal(pcds["feat"][..., 3:], pcds["coord"])
        assert ((pcds["feat"][..., :3] >= -1) & (pcds["feat"][..., :3] <= 1)).all()


def test_the_first_batch_of_each_shape_comes_first():
    items = [(0, 2048), (1, 2560), (2, 2560), (3, 1536), (4, 2048)]
    got = T.shapes_first(items, lambda it: it[1])
    assert [it[0] for it in got] == [0, 1, 3, 2, 4]


def test_requests_are_numpy_and_distinct():
    bench = harness.Bench(ROOT)
    cfg, tr, bld = harness._setup_common(bench, "dp_pcd.predict_b1", TINY["dp_predict"])
    reqs, data = bld.make_requests(cfg, tr, T.generator(1, "data", "cpu"))
    assert len(reqs) == tr["pool"]
    coord = reqs[0]["obs"]["pcds"]["coord"]
    assert coord.shape[0] == cfg["n_obs_steps"] and coord.shape[1] % 512 == 0
    assert not (reqs[0]["obs"]["pcds"]["coord"][:, :5] == reqs[1]["obs"]["pcds"]["coord"][:, :5]).all()
    assert set(data) == {"action", "qpos"}
