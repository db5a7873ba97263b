"""Camera frames of a ManiSkill2 scene, ray-cast on the device, and the
dataset's path from a frame to the cloud the model is fed.

A scene is ``benchmark/scenes/<name>.json``: the camera (pose by eye and
target, square side in pixels, vertical field of view, far plane), the
ground, the cube (half size, the range of its centre and yaw), the Panda
(base position, rest joint angles, the spread of the joints over a
demonstration, the link radii of its capsule model) and a catalog (how many
episode states, and the seed they are drawn from). Every run renders the
same catalog, so every seed asks the same work of the program; the run's
seed only orders it.

A frame is what ManiSkill2's ``pointcloud`` observation holds for one
camera: world ``xyz`` for each pixel, ``w`` (0 where the ray hits nothing
within the far plane) and ``rgb`` in uint8. :func:`data_path` then does
what ``ManiSkill2GoalPosSingleTaskACTPCDDataset._extract_pcd`` does with the
shipped ``transform_pcd`` (``configs/data/maniskill2_*_pcd_dataset.yaml``):
drop ``w = 0`` and the ground (``z <= 0.005``), keep one random point per
5 mm voxel (``GridSamplePCD``), colours to [-1, 1] (``NormalizeColorPCD``),
``feat = [colour, xyz]``; the collate then pads to a multiple of 512 slots
with the valid points first, in Morton order. ``tests/
test_benchmark_scenes.py`` holds the counts and voxels against the port's
own chain on the same frames.
"""

from __future__ import annotations

import json
import math
import os

import torch

from benchmark.traffic import morton_order

__all__ = ["load", "catalog", "render", "data_path", "frames", "panda_points", "camera_rays"]

SCENE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
# the Panda's modified Denavit-Hartenberg parameters (a_{i-1}, d_i, alpha_{i-1}),
# joints 1-7 and the flange (franka_description)
PANDA_DH = ((0.0, 0.333, 0.0), (0.0, 0.0, -math.pi / 2), (0.0, 0.316, math.pi / 2),
            (0.0825, 0.0, math.pi / 2), (-0.0825, 0.384, -math.pi / 2),
            (0.0, 0.0, math.pi / 2), (0.088, 0.0, math.pi / 2), (0.0, 0.107, 0.0))
_BIG = 1e9


def load(name: str) -> dict:
    with open(os.path.join(SCENE_DIR, name + ".json")) as f:
        return json.load(f)


def catalog(scene: dict, device) -> dict:
    """The scene's episode states, drawn from its own seed (never the run's):
    cube centre and yaw, and the arm's joints in two consecutive frames
    ``q0``, ``q1`` (n, 7), the gripper's opening (n,)."""
    cat, arm, cube = scene["catalog"], scene["panda"], scene["cube"]
    g = torch.Generator(device="cpu").manual_seed(int(cat["seed"]))
    n = int(cat["states"])
    u = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)  # noqa: E731
    lo, hi = cube["centre_xy_range"]
    xy = lo + (hi - lo) * u(n, 2)
    yaw = 2 * math.pi * u(n)
    rest = torch.tensor(arm["rest_qpos"], dtype=torch.float64)
    q0 = (rest + arm["init_noise"] * torch.randn((n, 7), generator=g, dtype=torch.float64)
          + arm["motion_spread"] * (2 * u(n, 7) - 1))
    q1 = q0 + arm["step_noise"] * torch.randn((n, 7), generator=g, dtype=torch.float64)
    grip = arm["gripper_open"] * u(n)
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    return {"cube_xy": f32(xy), "cube_yaw": f32(yaw), "q0": f32(q0), "q1": f32(q1),
            "gripper": f32(grip)}


def camera_rays(cam: dict, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(eye (3,), unit ray directions (side * side, 3) row by row, forward
    axis (3,)) of a pinhole camera looking from ``eye`` at ``target``, z up."""
    eye = torch.tensor(cam["eye"], dtype=torch.float64)
    fwd = torch.tensor(cam["target"], dtype=torch.float64) - eye
    fwd = fwd / fwd.norm()
    left = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), fwd)
    left = left / left.norm()
    up = torch.linalg.cross(fwd, left)
    side = int(cam["side"])
    focal = (side / 2) / math.tan(cam["fovy"] / 2)
    c = (torch.arange(side, dtype=torch.float64) + 0.5 - side / 2) / focal
    row, col = torch.meshgrid(c, c, indexing="ij")
    d = fwd + (-col.reshape(-1, 1)) * left + (-row.reshape(-1, 1)) * up
    d = d / d.norm(dim=1, keepdim=True)
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    return f32(eye), f32(d), f32(fwd)


def panda_points(q: torch.Tensor, base) -> tuple[list, torch.Tensor]:
    """The Panda's forward kinematics for joints ``q`` (n, 7): the points its
    links run between (each (n, 3), from the base up to the flange) and the
    flange's rotation (n, 3, 3), both in the world."""
    n = q.shape[0]
    R = torch.eye(3, device=q.device).expand(n, 3, 3)
    p = torch.tensor(base, device=q.device, dtype=q.dtype).expand(n, 3)
    pts = [p + torch.tensor([0.0, 0.0, 0.05], device=q.device)]

    def rot(axis, ang):
        c, s = torch.cos(ang), torch.sin(ang)
        o, z = torch.ones_like(c), torch.zeros_like(c)
        rows = ([[o, z, z], [z, c, -s], [z, s, c]] if axis == "x"
                else [[c, -s, z], [s, c, z], [z, z, o]])
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    for i, (a, d, alpha) in enumerate(PANDA_DH):
        theta = q[:, i] if i < 7 else torch.zeros(n, device=q.device)
        R = R @ rot("x", torch.full((n,), alpha, device=q.device))
        if a:
            p = p + a * R[..., 0]
            pts.append(p)
        R = R @ rot("z", theta)
        if d:
            p = p + d * R[..., 2]
            pts.append(p)
    return pts, R


def _capsule(ro, rd, a, b, r):
    """Distance along each ray (..., R) to a capsule from ``a`` to ``b`` of
    radius ``r`` (a, b (F, 1, 3)), ``_BIG`` where it misses."""
    ba, oa = b - a, ro - a
    baba = (ba * ba).sum(-1)
    bard = (ba * rd).sum(-1)
    baoa = (ba * oa).sum(-1)
    rdoa = (rd * oa).sum(-1)
    oaoa = (oa * oa).sum(-1)
    qa = (baba - bard * bard).clamp_min(1e-12)
    qb = baba * rdoa - baoa * bard
    qc = baba * oaoa - baoa * baoa - r * r * baba
    h = qb * qb - qa * qc
    t_side = (-qb - h.clamp_min(0).sqrt()) / qa
    y = baoa + t_side * bard
    side_hit = (h >= 0) & (y > 0) & (y < baba) & (t_side > 0)
    # the caps: the sphere at the nearer end
    oc = torch.where((y <= 0)[..., None], oa, ro - b)
    cb = (rd * oc).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    hc = cb * cb - cc
    t_cap = -cb - hc.clamp_min(0).sqrt()
    cap_hit = (hc > 0) & (t_cap > 0)
    return torch.where(side_hit, t_side, torch.where(cap_hit, t_cap, _BIG))


def _box(ro, rd, centre, yaw, half):
    """Distance along each ray to a box of half size ``half`` turned by
    ``yaw`` about z (centre (F, 1, 3), yaw (F, 1)), and the hit face's axis."""
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    o = ro - centre
    ox, oy = c * o[..., 0] - s * o[..., 1], s * o[..., 0] + c * o[..., 1]
    dx, dy = c * rd[..., 0] - s * rd[..., 1], s * rd[..., 0] + c * rd[..., 1]
    o = torch.stack([ox, oy, o[..., 2].expand_as(ox)], -1)
    d = torch.stack([dx, dy, rd[..., 2].expand_as(dx)], -1)
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1, t2 = (-half - o) / d, (half - o) / d
    tmin, axis = torch.minimum(t1, t2).max(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmin > 0)
    return torch.where(hit, tmin, _BIG), axis


def render(scene: dict, states: dict, frame: int, device) -> dict:
    """The camera's frame of each state (frame 0 or 1 of the pair): ``xyz``
    (F, P, 3) f32, ``w`` (F, P) bool and ``rgb`` (F, P, 3) uint8, P = side^2."""
    cam, arm, cube = scene["camera"], scene["panda"], scene["cube"]
    eye, rd, fwd = camera_rays(cam, device)
    rd = rd[None]  # (1, P, 3)
    ro = eye[None, None]
    F = states["q0"].shape[0]
    P = rd.shape[1]
    best = torch.full((F, P), _BIG, device=device)
    kind = torch.zeros((F, P), dtype=torch.int64, device=device)  # 0 none 1 ground 2 arm 3 cube
    shade = torch.zeros((F, P), device=device)

    def take(t, k, normal_dot):
        nonlocal best, kind, shade
        closer = t < best
        best = torch.where(closer, t, best)
        kind = torch.where(closer, k, kind)
        shade = torch.where(closer, normal_dot, shade)

    # the ground, z = 0
    dz = rd[..., 2]
    t_ground = torch.where(dz < -1e-9, -ro[..., 2] / dz.clamp(max=-1e-9), _BIG).expand(F, P)
    take(t_ground, 1, torch.ones((F, P), device=device))
    # the Panda as capsules between its joints, and its hand
    pts, Rf = panda_points(states["q" + str(frame)], arm["base"])
    radii = arm["link_radii"]
    caps = [(pts[i], pts[i + 1], radii[i]) for i in range(len(pts) - 1)]
    hand_y = (Rf[..., 0] * -math.sin(math.pi / 4) + Rf[..., 1] * math.cos(math.pi / 4))
    hand_z = Rf[..., 2]
    flange = pts[-1]
    hw, hr = arm["hand_half_width"], arm["hand_radius"]
    caps.append((flange + 0.03 * hand_z - hw * hand_y, flange + 0.03 * hand_z + hw * hand_y, hr))
    grip = states["gripper"][:, None] + arm["finger_radius"]
    for sign in (1.0, -1.0):
        foot = flange + sign * grip * hand_y
        caps.append((foot + 0.06 * hand_z, foot + 0.11 * hand_z, arm["finger_radius"]))
    for a, b, r in caps:
        t = _capsule(ro, rd, a[:, None], b[:, None], r)
        p = ro + t[..., None].clamp(max=10.0) * rd
        ab = b[:, None] - a[:, None]
        s = (((p - a[:, None]) * ab).sum(-1) / (ab * ab).sum(-1).clamp_min(1e-12)).clamp(0, 1)
        nrm = p - (a[:, None] + s[..., None] * ab)
        nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        take(t, 2, (-(nrm * rd).sum(-1)).abs())
    # the cube
    h = cube["half_size"]
    centre = torch.cat([states["cube_xy"], torch.full((F, 1), h, device=device)], -1)[:, None]
    t_cube, axis = _box(ro, rd, centre, states["cube_yaw"][:, None], h)
    take(t_cube, 3, torch.where(axis == 2, 1.0, 0.7))

    depth = best * (rd * fwd).sum(-1)
    w = (kind > 0) & (depth <= cam["far"])
    xyz = torch.where(w[..., None], ro + best[..., None] * rd, 0.0)
    colours = torch.tensor([[0, 0, 0], scene["ground"]["rgb"], arm["rgb"], cube["rgb"]],
                           dtype=torch.float32, device=device)
    rgb = colours[kind] * (0.35 + 0.65 * shade[..., None])
    rgb = torch.where(w[..., None], rgb, 0.0).round().clamp(0, 255).to(torch.uint8)
    return {"xyz": xyz, "w": w, "rgb": rgb}


def voxel_pick(xyz: torch.Tensor, keep: torch.Tensor, grid: float,
               gen: torch.Generator) -> torch.Tensor:
    """(F, P) bool: of the ``keep`` points of each frame, one drawn at random
    from each ``grid``-sized voxel (``GridSamplePCD`` in train mode)."""
    F, P = keep.shape
    dev = xyz.device
    g = torch.floor(xyz / grid).to(torch.int64) + 4096  # 13 bits an axis, +-20 m at 5 mm
    key = (torch.arange(F, device=dev)[:, None] << 39) | (g[..., 0] << 26) | (g[..., 1] << 13) \
        | g[..., 2]
    key = torch.where(keep, key, -1).reshape(-1)
    prio = torch.rand(F * P, generator=gen, device=dev)
    prio = torch.where(key >= 0, prio, 2.0)
    uniq, inv = torch.unique(key, return_inverse=True)
    best = torch.full((uniq.shape[0],), 3.0, device=dev).scatter_reduce(0, inv, prio, "amin")
    chosen = (prio == best[inv]) & (key >= 0)
    return chosen.view(F, P)


def data_path(frame: dict, gen: torch.Generator, grid: float, ground_z: float,
              pad_multiple: int) -> dict:
    """The dataset's cloud of each frame, padded as the collate pads a batch
    (to the largest count rounded up to ``pad_multiple``): {"coord" (F,
    slots, 3), "feat" (F, slots, 6), "valid" (F, slots)}, the valid points
    first, in Morton order."""
    keep = frame["w"] & (frame["xyz"][..., 2] > ground_z)
    chosen = voxel_pick(frame["xyz"], keep, grid, gen)
    counts = chosen.sum(1)
    slots = -(-int(counts.max()) // pad_multiple) * pad_multiple
    # the chosen points to the front of each row, in pixel order (then Morton)
    order = torch.argsort((~chosen).to(torch.int8), dim=1, stable=True)[:, :slots]
    valid = torch.arange(slots, device=chosen.device)[None] < counts[:, None]
    coord = torch.gather(frame["xyz"], 1, order[..., None].expand(-1, -1, 3))
    colour = torch.gather(frame["rgb"], 1, order[..., None].expand(-1, -1, 3)).float() / 127.5 - 1
    coord = torch.where(valid[..., None], coord, 0.0)
    colour = torch.where(valid[..., None], colour, 0.0)
    m = morton_order(coord, valid)
    coord = torch.gather(coord, 1, m[..., None].expand(-1, -1, 3))
    colour = torch.gather(colour, 1, m[..., None].expand(-1, -1, 3))
    return {"coord": coord.contiguous(), "feat": torch.cat([colour, coord], dim=-1),
            "valid": valid}


def frames(name: str, device, overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """(scene, catalog states, both frames of every state rendered) of scene
    ``name``, the keys of each group in ``overrides`` replaced (the number of
    states, the tests' small cameras)."""
    scene = load(name)
    for group, keys in (overrides or {}).items():
        scene[group] = {**scene[group], **keys}
    states = catalog(scene, device)
    return scene, states, {f: render(scene, states, f, device) for f in (0, 1)}
