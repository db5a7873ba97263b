"""The one traffic generator: every array a cell feeds the program, drawn on
the device from the run's seed.

A traffic mix is a JSON file under ``benchmark/traffic/`` whose numbers this
module reads (batch size, the scene its clouds come from and how many of its
states, the pool of distinct batches or requests); a configuration's adapter
arranges the pieces into the batch layout of its model.

Clouds are camera frames of a ManiSkill2 scene (``scenes.py``), taken
through the dataset's own path: the ground dropped, one point per 5 mm
voxel, padded as the collate pads a batch, valid points first in Morton
order; ``feat`` is ``[colour, xyz]``. The catalog of scene states, and so
every cloud's count and every batch's shape, is the same for every seed;
the run's seed draws the point kept in each voxel and every other array
(qpos, goals, actions, the weights).
"""

from __future__ import annotations

import hashlib

import torch

__all__ = ["derive_seed", "generator", "scene_frames", "clouds", "shapes_first", "normal",
           "to_numpy", "morton_order"]

_INT32_MAX = 2**31 - 1


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose ("data", "weights", ...) of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, purpose))


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(coord: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(C, N) permutation: each cloud's valid points along a 10-bit Morton
    curve over their bounding box (stable on equal codes), then the padding."""
    big = torch.finfo(torch.float32).max
    lo = torch.where(valid[..., None], coord, big).amin(dim=1, keepdim=True)
    hi = torch.where(valid[..., None], coord, -big).amax(dim=1, keepdim=True)
    q = ((coord - lo) * (1023.0 / torch.clamp_min(hi - lo, 1e-6))).clamp(0, 1023).to(torch.int64)
    code = _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1) | (_part1by2(q[..., 2]) << 2)
    code = torch.where(valid, code, _INT32_MAX)
    return torch.argsort(code, dim=1, stable=True)


def scene_frames(tr: dict, device) -> tuple[dict, dict]:
    """(scene, both frames of each of its catalog states) of the traffic's
    ``scene``, with ``states`` states and the groups of ``scene_overrides``
    replaced key by key (the tests' small cameras)."""
    from benchmark import scenes

    overrides = {**tr.get("scene_overrides", {}), "catalog": {"states": tr["states"]}}
    scene, _, frames = scenes.frames(tr["scene"], device, overrides)
    return scene, frames


def clouds(scene: dict, frames: dict, index: torch.Tensor, gen: torch.Generator,
           both: bool = False) -> dict:
    """The dataset's clouds of the states ``index`` (frame 0; with ``both``
    frames 0 and 1 of each state, state by state), padded as the collate
    pads them: to the batch's largest count rounded up to the multiple."""
    if both:
        pick = {k: torch.stack([frames[0][k][index], frames[1][k][index]], 1).flatten(0, 1)
                for k in frames[0]}
    else:
        pick = {k: v[index] for k, v in frames[0].items()}
    path = scene["data_path"]
    from benchmark import scenes

    return scenes.data_path(pick, gen, path["grid_size"], path["ground_z"], path["pad_multiple"])


def shapes_first(items: list, slots) -> list:
    """``items`` with the first of each distinct ``slots(item)`` moved to the
    front, in order: warming up on the first few then covers every shape."""
    seen, first, rest = set(), [], []
    for it in items:
        (rest if slots(it) in seen else first).append(it)
        seen.add(slots(it))
    return first + rest


def normal(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def to_numpy(tree):
    """A nested dict of tensors as numpy arrays on the host, as a client
    sends a request."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()
