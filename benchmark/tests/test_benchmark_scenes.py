"""The scene's frames and the generator's data path against the port's own
dataset chain (``_extract_pcd`` with the shipped ``transform_pcd``) on the
same frames: the same number of points per cloud and the same voxels."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import scenes as S

SCENE = "maniskill2_pickcube_base_camera"


def _port_chain():
    from pointcloudmatters_tpu_torch.data.components import transformpcd as TP

    # configs/data/maniskill2_act_pcd_dataset.yaml's transform_pcd
    return TP.ComposePCD([
        TP.GridSamplePCD(grid_size=0.005, hash_type="fnv", mode="train", return_grid_coord=True,
                         return_displacement=False, keys=["coord", "color"]),
        TP.NormalizeColorPCD(), TP.ShufflePointPCD(), TP.ToTensorPCD(),
        TP.CollectPCD(keys=["coord", "grid_coord"], feat_keys=["color", "coord"])])


def test_the_data_path_keeps_what_the_dataset_keeps():
    from pointcloudmatters_tpu_torch.data.components.maniskill2 import (
        ManiSkill2GoalPosSingleTaskACTPCDDataset as Dataset,
    )

    overrides = {"catalog": {"states": 6, "seed": 5}, "camera": {"side": 64}}
    scene, _, frames = S.frames(SCENE, "cpu", overrides)
    side = scene["camera"]["side"]
    ours = S.data_path(frames[0], torch.Generator().manual_seed(0), 0.005, 0.005, 512)
    dataset = SimpleNamespace(point_num_per_cam=side * side, camera_ids=[0], pointmap=False,
                              rand_crop=False, include_ground=False,
                              transform_pcd=_port_chain())
    np.random.seed(0)
    for i in range(6):
        xyzw = torch.cat([frames[0]["xyz"][i], frames[0]["w"][i, :, None].float()], -1)
        traj = {"obs": {"pointcloud": {"xyzw": xyzw.numpy()[None],
                                        "rgb": frames[0]["rgb"][i].numpy()[None]}}}
        theirs = Dataset._extract_pcd(dataset, traj, 0)
        n = int(ours["valid"][i].sum())
        assert len(theirs["coord"]) == n > 0
        vox = lambda c: {tuple(v) for v in np.floor(np.asarray(c) / 0.005).astype(int).tolist()}  # noqa: E731,E501
        assert vox(theirs["coord"]) == vox(ours["coord"][i, :n])
        # one point per voxel, the colours normalised as the dataset does
        assert len(vox(ours["coord"][i, :n])) == n
        got = ours["feat"][i, :n, :3]
        assert (got >= -1).all() and (got <= 1).all()


def test_the_panda_reaches_its_ready_pose():
    """franka_description's ready pose puts the flange at (0.307, 0, 0.590)."""
    q = torch.tensor([[0.0, -math.pi / 4, 0.0, -3 * math.pi / 4, 0.0, math.pi / 2, math.pi / 4]])
    pts, R = S.panda_points(q, [0.0, 0.0, 0.0])
    assert torch.allclose(pts[-1][0], torch.tensor([0.3069, 0.0, 0.5900]), atol=1e-3)
    assert torch.allclose(R[0, :, 2], torch.tensor([0.0, 0.0, -1.0]), atol=1e-5)


def test_the_camera_looks_at_its_target():
    cam = {**S.load(SCENE)["camera"], "side": 2}
    eye, rays, fwd = S.camera_rays(cam, "cpu")
    centre = rays.mean(0)
    centre = centre / centre.norm()
    want = torch.tensor(cam["target"]) - torch.tensor(cam["eye"])
    assert torch.allclose(centre, want / want.norm(), atol=1e-6)
    # the top of the image looks up, its left to the camera's left (-y: it looks along -x)
    assert rays[0, 2] > rays[2, 2] and rays[0, 1] < rays[1, 1]


def test_every_run_renders_the_same_catalog():
    a = S.catalog(S.load(SCENE), "cpu")
    b = S.catalog(S.load(SCENE), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
