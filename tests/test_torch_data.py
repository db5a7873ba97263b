"""Parity of the port's data layer with the JAX package's, on the CPU: every
transform, the collate, the loader's index batches, the ManiSkill2 ACT
point-cloud datasets and the datamodule's collate choice.

Each case seeds numpy's global stream (and Python's ``random``, which two
transforms draw from) the same way before each side, and holds the port's
output bit-equal to the JAX package's, dtypes included, and the streams
where each side left them equal: the port draws what JAX draws, in the same
order. ``GridSamplePCD``'s train mode is held on each of its routes against
JAX's same route: the native library (the port builds
``native/pcm_native.cpp`` itself) and numpy (both packages' native entry
returning None).
"""

import copy
import random
from collections.abc import Mapping

import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.data import collate as jcollate
from pointcloudmatters_tpu.data import native as jnative
from pointcloudmatters_tpu.data.base_datamodule import BaseDataModule as JDataModule
from pointcloudmatters_tpu.data.components import maniskill2 as jms2
from pointcloudmatters_tpu.data.components import transformpcd as JT
from pointcloudmatters_tpu.data.components.misc import DummyDataset as JDummy
from pointcloudmatters_tpu.data.loader import DataLoader as JDataLoader
from pointcloudmatters_tpu_torch.data import collate as tcollate
from pointcloudmatters_tpu_torch.data import native as tnative
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.data.components import maniskill2 as tms2
from pointcloudmatters_tpu_torch.data.components import transformpcd as T
from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset
from pointcloudmatters_tpu_torch.data.loader import DataLoader
from tests.synth import make_synthetic_maniskill2

CAM_SIDE = 16


def _equal(got, ref, where="out"):
    assert type(got) is type(ref) or (
        isinstance(got, Mapping) and isinstance(ref, Mapping)), (where, type(got), type(ref))
    if isinstance(ref, Mapping):
        assert list(got) == list(ref), (where, list(got), list(ref))
        for k in ref:
            _equal(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _equal(g, r, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, (where, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


def _seed(seed):
    np.random.seed(seed)
    random.seed(seed)


def _both(jfn, tfn, make, seed=0):
    """``jfn(make())`` and ``tfn(make())`` from the same seeds: the outputs
    bit-equal and the random streams left at the same place."""
    _seed(seed)
    ref = jfn(make())
    ref_state = (np.random.get_state()[1].copy(), random.getstate())
    _seed(seed)
    got = tfn(make())
    np.testing.assert_array_equal(np.random.get_state()[1], ref_state[0])
    assert random.getstate() == ref_state[1]
    _equal(got, ref)
    return got


def _cloud(n=400, seed=5, extent=(0.4, 0.4, 0.3)):
    """A tabletop-like cloud with the keys the transforms read."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(n, 3) * extent - [extent[0] / 2, extent[1] / 2, 0]).astype(np.float32)
    normal = rng.randn(n, 3).astype(np.float32)
    return dict(coord=coord, color=rng.randint(0, 255, (n, 3)).astype(np.float32),
                normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
                segment=rng.randint(0, 5, n))


# name, constructor keywords; every transform of the module
TRANSFORMS = [
    ("CollectPCD", dict(keys=("coord", "segment"), feat_keys=("color", "coord"))),
    ("CopyPCD", {}),
    ("ToTensorPCD", {}),
    ("NormalizeColorPCD", {}),
    ("NormalizeCoordPCD", {}),
    ("PositiveShiftPCD", {}),
    ("CenterShiftPCD", dict(apply_z=True)),
    ("CenterShiftPCD", dict(apply_z=False)),
    ("RandomShiftPCD", {}),
    ("RandomDropoutPCD", dict(dropout_ratio=0.3, dropout_application_ratio=1.0)),
    ("RandomRotatePCD", dict(angle=[-1, 1], axis="z", always_apply=True)),
    ("RandomRotatePCD", dict(angle=[-1 / 6, 1 / 6], axis="x", p=0.5)),
    ("RandomScalePCD", dict(scale=[0.9, 1.1], anisotropic=True)),
    ("RandomFlipPCD", dict(p=0.5)),
    ("RandomJitterPCD", dict(sigma=0.005, clip=0.02)),
    ("ClipGaussianJitterPCD", dict(store_jitter=True)),
    ("ChromaticAutoContrastPCD", dict(p=1.0)),
    ("ChromaticTranslationPCD", dict(p=1.0)),
    ("ChromaticJitterPCD", dict(p=1.0)),
    ("RandomColorGrayScalePCD", dict(p=1.0)),
    ("RandomColorJitterPCD", dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
                                  p=1.0)),
    ("HueSaturationTranslationPCD", {}),
    ("RandomColorDropPCD", dict(p=1.0)),
    ("ShufflePointPCD", {}),
]


@pytest.mark.parametrize("name, kw", TRANSFORMS, ids=[f"{n}-{i}" for i, (n, _) in
                                                      enumerate(TRANSFORMS)])
def test_transform_matches_jax(name, kw):
    for seed in (0, 1):
        _both(getattr(JT, name)(**kw), getattr(T, name)(**kw), _cloud, seed)


def test_to_tensor_keeps_numpy():
    """numpy stays numpy: floats to float32, ints to int64, bools as they
    are, scalars to one-element arrays, strings and nesting kept."""
    data = dict(a=np.arange(3, dtype=np.int32), b=np.ones(2), c=np.array([True]), d=3,
                e=2.5, f="x", g=[np.zeros(1, np.float16)])
    got = _both(JT.ToTensorPCD(), T.ToTensorPCD(), lambda: data)
    assert not any(torch.is_tensor(v) for v in got.values())


def _no_native(monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "grid_subsample_train", lambda *a, **k: None)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("grid", [0.005, 0.02, 0.05])
@pytest.mark.parametrize("extra", [{}, dict(return_min_coord=True, return_displacement=True,
                                            keys=("coord", "color", "normal", "segment"))])
def test_grid_sample_train_matches_jax(route, grid, extra, monkeypatch):
    """Train mode (one random point a voxel, several points a voxel at the
    coarser grids), on each route against JAX's same route."""
    if route == "numpy":
        _no_native(monkeypatch)
    else:
        assert tnative.route() == "native" and jnative.available()
    kw = dict(dict(grid_size=grid, hash_type="fnv", mode="train", return_grid_coord=True,
                   keys=("coord", "color")), **extra)
    for seed in (0, 1, 2):
        got = _both(JT.GridSamplePCD(**kw), T.GridSamplePCD(**kw), _cloud, seed)
        assert len(got["coord"]) == len(np.unique(T.fnv_hash_vec(got["grid_coord"])))


@pytest.mark.parametrize("hash_type", ["fnv", "ravel"])
def test_grid_sample_test_mode_and_ravel_match_jax(hash_type):
    """Test mode (the full partition of the voxels' points), and train mode
    on the ravel hash (numpy only)."""
    for mode in ("test", "train"):
        kw = dict(grid_size=0.05, hash_type=hash_type, mode=mode, return_grid_coord=True,
                  return_min_coord=True, keys=("coord", "color"))
        _both(JT.GridSamplePCD(**kw), T.GridSamplePCD(**kw), _cloud)


def test_hashes_match_jax():
    coords = np.random.RandomState(0).randint(0, 300, (500, 3))
    _equal(T.fnv_hash_vec(coords), JT.fnv_hash_vec(coords))
    _equal(T.ravel_hash_vec(coords), JT.ravel_hash_vec(coords))
    _equal(tnative.fnv_hash(coords), jnative.fnv_hash(coords))
    _equal(tnative.fnv_hash(coords), T.fnv_hash_vec(coords))
    _equal(tnative.grid_segments(coords), jnative.grid_segments(coords))


def _flagship_transforms(pkg, extra=()):
    """``configs/data/maniskill2_act_pcd_dataset.yaml``'s transforms (its
    grid of 0.005 unless given), and ``extra`` before the collect."""
    return [
        pkg.GridSamplePCD(grid_size=0.005, hash_type="fnv", mode="train",
                          return_grid_coord=True, return_displacement=False,
                          keys=("coord", "color")),
        pkg.NormalizeColorPCD(),
        pkg.ShufflePointPCD(),
        *[getattr(pkg, name)(**kw) for name, kw in extra],
        pkg.ToTensorPCD(),
        pkg.CollectPCD(keys=("coord", "grid_coord"), feat_keys=("color", "coord")),
    ]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_compose_matches_jax(mode):
    """The flagship's pipeline with a jitter and a rotation: outside train
    mode the classes named rand/jitter/shuffle are skipped, on both sides."""
    extra = [("RandomJitterPCD", {}), ("RandomRotatePCD", dict(angle=[-1, 1], axis="z"))]
    got = _both(lambda d: JT.ComposePCD(_flagship_transforms(JT, extra))(d, mode=mode),
                lambda d: T.ComposePCD(_flagship_transforms(T, extra))(d, mode=mode),
                lambda: {k: _cloud()[k] for k in ("coord", "color")})
    assert set(got) == {"coord", "grid_coord", "offset", "feat"}


# ---------------------------------------------------------------------------
# collate and loader
# ---------------------------------------------------------------------------

def _samples(n=5, holder=None, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        m = int(rng.randint(40, 300))
        pcd = dict(coord=rng.rand(m, 3).astype(np.float32),
                   grid_coord=rng.randint(0, 50, (m, 3)),
                   feat=rng.rand(m, 6).astype(np.float32),
                   offset=np.array([m]), min_coord=rng.rand(1, 3))
        sample = dict(qpos=rng.randn(9).astype(np.float32), is_pad=rng.rand(5) > 0.5,
                      actions=rng.randn(5, 7).astype(np.float32))
        if holder:
            sample["obs"] = dict(pcds=[pcd, pcd], agent_pos=rng.randn(2, 9))
        else:
            sample["pcds"] = [pcd]
        out.append(sample)
    return out


@pytest.mark.parametrize("pad_multiple, max_points", [(512, None), (64, None), (64, 128)])
@pytest.mark.parametrize("holder", [None, "obs"])
def test_padded_collate_matches_jax(pad_multiple, max_points, holder):
    batch = _samples(holder=holder)
    got = _both(lambda b: jcollate.padded_pcd_collate_fn(b, pad_multiple, max_points),
                lambda b: tcollate.padded_pcd_collate_fn(b, pad_multiple, max_points),
                lambda: batch)
    pcds = (got["obs"] if holder else got)["pcds"]
    assert pcds["clouds_per_sample"] == (2 if holder else 1)


@pytest.mark.parametrize("spatial_sort", [True, False])
def test_pad_point_clouds_matches_jax(spatial_sort):
    pcds = [s["pcds"][0] for s in _samples(4)]
    got = _both(lambda p: jcollate.pad_point_clouds(p, 64, None, spatial_sort),
                lambda p: tcollate.pad_point_clouds(p, 64, None, spatial_sort), lambda: pcds)
    assert got["valid"].sum(1).tolist() == got["count"].tolist()


def test_default_collate_matches_jax():
    batch = [dict(a=np.arange(3) + i, b=[np.ones(2) * i, "s"], c=i) for i in range(3)]
    _both(jcollate.default_collate, tcollate.default_collate, lambda: batch)


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False), (True, False),
                                                (False, True)])
@pytest.mark.parametrize("proc", [(None, None), (0, 2), (1, 2)])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_index_batches_match_jax(shuffle, drop_last, proc, num_workers):
    """11 indices in batches of 3 over 3 epochs (``epoch`` goes up at every
    ``__iter__``, shuffling with ``seed + epoch``), also at process 0 and 1
    of 2, and built by two threads: the port's batches and lengths are
    JAX's."""
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=7,
              process_index=proc[0], process_count=proc[1])
    ref = JDataLoader(JDummy(11), **kw)
    got = DataLoader(DummyDataset(11), num_workers=num_workers, **kw)
    assert len(got) == len(ref)
    for epoch in range(3):
        _equal(list(got), list(ref), f"epoch {epoch}")
    assert got.epoch == ref.epoch == 3


def test_loader_raises_a_sample_error_and_stops_its_threads():
    """A sample that raises reaches the consumer; a consumer that stops
    early stops the producer."""
    class Bad(DummyDataset):
        def __getitem__(self, idx):
            if idx == 4:
                raise ValueError("bad sample")
            return idx

    with pytest.raises(ValueError, match="bad sample"):
        list(DataLoader(Bad(10), batch_size=2, num_workers=2))
    batches = iter(DataLoader(DummyDataset(100), batch_size=2, num_workers=3))
    assert next(batches).tolist() == [0, 1]
    batches.close()


def test_loader_split_follows_torch_distributed(monkeypatch):
    """Without explicit arguments the process split is the initialised
    ``torch.distributed`` group's."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    got = DataLoader(DummyDataset(11), batch_size=3)
    ref = JDataLoader(JDummy(11), batch_size=3, process_index=1, process_count=2)
    assert got._proc() == (1, 2) and len(got) == len(ref)
    _equal(list(got), list(ref))


# ---------------------------------------------------------------------------
# the ManiSkill2 datasets and the datamodule
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ms2") / "trajectory.pointcloud.pd_ee_delta_pose.h5"
    return make_synthetic_maniskill2(str(path), n_episodes=4, episode_len=10,
                                     cam_side=CAM_SIDE)


DATASETS = [
    ("ManiSkill2GoalPosSingleTaskACTPCDDataset", dict(goal_cond_keys=["goal_pos"])),
    ("ManiSkill2GoalPosSingleTaskACTPCDDataset",
     dict(goal_cond_keys=["goal_pos", "target_angle_diff"], load_count=2, loop=3)),
    ("ManiSkill2GoalPosSingleTaskACTPCDDataset",
     dict(goal_cond_keys=["obj_start_pos"], load_count=0.5, cache_traj=False)),
    ("ManiSkill2GoalPosSingleTaskACTPCDDataset",
     dict(goal_cond_keys=["goal_pos"], include_ground=True, rand_crop=True)),
    ("ManiSkill2GoalPosSingleTaskACTPCDDataset",
     dict(goal_cond_keys=["goal_pos"], pointmap=True)),
    ("ManiSkill2NullGoalSingleTaskACTPCDDataset", dict(load_count=3, chunk_size=4)),
]


@pytest.mark.parametrize("name, kw", DATASETS, ids=[
    f"{n[11:].split('SingleTask')[0]}-{i}" for i, (n, _) in enumerate(DATASETS)])
def test_maniskill2_dataset_matches_jax(name, kw, h5file, tmp_path):
    """Length, normalisation statistics (computed, then read from each
    side's own cache) and 6 samples, bit-equal."""
    def build(mod, cache):
        return getattr(mod, name)(
            h5file, transform_pcd=_flagship_transforms(JT if mod is jms2 else T),
            point_num_per_cam=CAM_SIDE * CAM_SIDE, cache_dir=str(tmp_path / cache),
            **{"chunk_size": 6, **kw})

    for _ in range(2):  # the second round reads the statistics from the caches
        ref, got = build(jms2, "jax"), build(tms2, "torch")
        assert len(got) == len(ref) and got.load_count == ref.load_count
        _equal(got.norm_stats, ref.norm_stats)
        _both(lambda _: [ref[i] for i in range(6)], lambda _: [got[i] for i in range(6)],
              lambda: None)


def test_dataset_reads_the_file_in_one_method(h5file, tmp_path):
    """``_read_file`` is the only read of the demo file: a subclass that
    hands over trajectories held in memory gives the same samples."""
    import h5py

    from pointcloudmatters_tpu_torch.utils.io import load_h5_data, load_json

    with h5py.File(h5file, "r") as f:
        held = {int(k.split("_")[1]): load_h5_data(f[k]) for k in f}
    meta = load_json(h5file.replace(".h5", ".json"))

    class InMemory(tms2.ManiSkill2GoalPosSingleTaskACTPCDDataset):
        def _read_file(self, episode_ids):
            return meta, [copy.deepcopy(held[i]) for i in episode_ids]

    kw = dict(goal_cond_keys=["goal_pos"], chunk_size=6, point_num_per_cam=CAM_SIDE ** 2,
              transform_pcd=_flagship_transforms(T))
    ref = tms2.ManiSkill2GoalPosSingleTaskACTPCDDataset(
        h5file, cache_dir=str(tmp_path / "a"), **kw)
    got = InMemory("in-memory.h5", cache_dir=str(tmp_path / "b"), **kw)
    _equal(got.norm_stats, ref.norm_stats)
    _both(lambda _: [ref[i] for i in range(4)], lambda _: [got[i] for i in range(4)],
          lambda: None)


@pytest.mark.parametrize("which", ["pcd", "dummy"])
def test_datamodule_collate_choice_matches_jax(which, h5file, tmp_path):
    """The point-cloud collate for a dataset whose name holds "pcd", the
    default one otherwise: two epochs of training batches, and the
    validation batches, bit-equal; without a CUDA device ``pin_memory``
    leaves the batch numpy."""
    def datamodule(jax_side, pin):
        ms2, pkg, Dummy, DM = ((jms2, JT, JDummy, JDataModule) if jax_side else
                               (tms2, T, DummyDataset, BaseDataModule))
        data = (ms2.ManiSkill2GoalPosSingleTaskACTPCDDataset(
            h5file, goal_cond_keys=["goal_pos"], chunk_size=6,
            transform_pcd=_flagship_transforms(pkg), point_num_per_cam=CAM_SIDE ** 2,
            cache_dir=str(tmp_path / ("jax" if jax_side else "torch")))
            if which == "pcd" else Dummy(size=7))
        return DM(train=data, val=data, batch_size_train=2, batch_size_val=3,
                  pad_multiple=128, pin_memory=pin, seed=3)

    ref = datamodule(True, True)
    for pin in (False, True):
        got = datamodule(False, pin)
        want = "padded_pcd_collate_fn" if which == "pcd" else "default_collate"
        collate = got._collate_for(got.data_train)
        assert getattr(collate, "func", collate).__name__ == want

        def batches(dm):
            return [list(dm.train_dataloader()) for _ in range(2)] + [list(dm.val_dataloader())]

        _both(lambda _: batches(ref), lambda _: batches(got), lambda: None)


RGBD_DATASETS = [
    ("ManiSkill2GoalPosSingleTaskACTRGBDDataset", dict(goal_cond_keys=["goal_pos"])),
    ("ManiSkill2GoalPosSingleTaskACTRGBDDataset",
     dict(goal_cond_keys=["goal_pos", "obj_start_pos"], include_depth=True)),
    ("ManiSkill2GoalPosSingleTaskACTRGBDDataset",
     dict(goal_cond_keys=["goal_pos"], include_depth=True, scale_rgb_only=True, load_count=2,
          loop=3)),
    ("ManiSkill2GoalPosSingleTaskACTRGBDDataset",
     dict(goal_cond_keys=["goal_pos"], include_depth=True, only_depth=True, cache_traj=False)),
    ("ManiSkill2NullGoalSingleTaskACTRGBDDataset",
     dict(include_depth=True, load_count=3, chunk_size=4)),
]


@pytest.fixture(scope="module")
def front_camera_file(h5file, tmp_path_factory):
    """The demo file with its camera renamed ``front_camera`` (ManiSkill2's
    name in some tasks), which a ``base_camera`` dataset falls back to."""
    import shutil

    import h5py

    path = str(tmp_path_factory.mktemp("front") / "trajectory.rgbd.h5")
    shutil.copy(h5file, path)
    shutil.copy(h5file.replace(".h5", ".json"), path.replace(".h5", ".json"))
    with h5py.File(path, "a") as f:
        for traj in f:
            f.move(f"{traj}/obs/image/base_camera", f"{traj}/obs/image/front_camera")
    return path


@pytest.mark.parametrize("camera", ["base_camera", "front_camera"])
@pytest.mark.parametrize("name, kw", RGBD_DATASETS, ids=[
    f"{n[11:].split('SingleTask')[0]}-{i}" for i, (n, _) in enumerate(RGBD_DATASETS)])
def test_maniskill2_rgbd_dataset_matches_jax(name, kw, camera, h5file, front_camera_file,
                                             tmp_path):
    """The ACT RGB-D datasets in each mode (RGB; RGB-D; depth unscaled with
    ``scale_rgb_only``; depth only; the zero goal), on the demo's
    ``base_camera`` and on a demo whose camera is ``front_camera``: length,
    statistics and 6 samples bit-equal; images channel-last (k, h, w, c)."""
    path = h5file if camera == "base_camera" else front_camera_file

    def build(mod, cache):
        return getattr(mod, name)(path, camera_names=["base_camera"],
                                  cache_dir=str(tmp_path / cache), **{"chunk_size": 6, **kw})

    ref, got = build(jms2, "jax"), build(tms2, "torch")
    assert len(got) == len(ref)
    _equal(got.norm_stats, ref.norm_stats)
    samples = _both(lambda _: [ref[i] for i in range(6)], lambda _: [got[i] for i in range(6)],
                    lambda: None)
    channels = 1 if kw.get("only_depth") else 4 if kw.get("include_depth") else 3
    assert samples[0]["image"].shape == (1, 32, 32, channels)


@pytest.mark.parametrize("which", ["rgbd", "pointmap"])
def test_image_batches_collate_as_jax(which, h5file, tmp_path):
    """The datamodule's batches of the RGB-D dataset (the default collate)
    and of the point-cloud dataset's pointmap (the point-cloud collate,
    which has no cloud to pad): two epochs and a validation pass bit-equal,
    ``image`` (B, 1, h, w, C) among them."""
    def datamodule(jax_side):
        ms2, pkg, DM = (jms2, JT, JDataModule) if jax_side else (tms2, T, BaseDataModule)
        cache = str(tmp_path / ("jax" if jax_side else "torch"))
        if which == "rgbd":
            data = ms2.ManiSkill2GoalPosSingleTaskACTRGBDDataset(
                h5file, goal_cond_keys=["goal_pos"], include_depth=True, chunk_size=6,
                cache_dir=cache)
        else:
            data = ms2.ManiSkill2GoalPosSingleTaskACTPCDDataset(
                h5file, goal_cond_keys=["goal_pos"], chunk_size=6, pointmap=True,
                transform_pcd=_flagship_transforms(pkg), point_num_per_cam=CAM_SIDE ** 2,
                cache_dir=cache)
        return DM(train=data, val=data, batch_size_train=2, batch_size_val=3, pad_multiple=128,
                  pin_memory=False, seed=3)

    def batches(dm):
        return [list(dm.train_dataloader()) for _ in range(2)] + [list(dm.val_dataloader())]

    out = _both(lambda _: batches(datamodule(True)), lambda _: batches(datamodule(False)),
                lambda: None)
    side, channels = (32, 4) if which == "rgbd" else (CAM_SIDE, 6)
    assert out[0][0]["image"].shape == (2, 1, side, side, channels)
