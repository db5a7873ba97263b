"""Point-cloud transform pipeline, numpy on the host (port of
``pointcloudmatters_tpu/data/components/transformpcd.py``, itself a port of
the reference's 24 composable transforms with the same class names and
config parameters).

- Everything stays numpy until the collate pads to fixed shapes for the
  device. ``ToTensorPCD`` therefore normalises dtypes (float -> float32,
  int -> int64) and returns numpy arrays.
- ``GridSamplePCD``'s train mode takes the native route (``data/native.py``)
  where its library builds and loads, else numpy; the two pick different
  points a voxel from the same seed, and each is bit-equal to the JAX
  package's same route.
- ``HueSaturationTranslationPCD.__call__`` in the reference crashes on a
  wrong class name; this one works.

Quirk kept: ``ComposePCD`` skips transforms whose *class name* contains
"rand", "jitter" or "shuffle" outside train mode.
"""

from __future__ import annotations

import copy
import numbers
import random
from collections.abc import Mapping, Sequence

import numpy as np

# keys that are per-point arrays and must be subsampled/shuffled together
_PER_POINT_KEYS = (
    "coord", "grid_coord", "displacement", "color", "normal",
    "segment", "instance", "strength",
)


def _subsample(data_dict: dict, idx: np.ndarray, keys=_PER_POINT_KEYS) -> dict:
    for key in keys:
        if key in data_dict:
            data_dict[key] = data_dict[key][idx]
    return data_dict


def _apply_inverse_to_matrix_keys(data_dict: dict, S: np.ndarray, keys) -> None:
    """Right-multiply stored 4x4 matrices (e.g. camera extrinsics) by S^-1."""
    S = np.linalg.inv(S)
    for key in keys:
        assert key in data_dict
        for i in range(len(data_dict[key])):
            data_dict[key][i] = data_dict[key][i] @ S


class CollectPCD:
    """Final packaging: select keys, concat ``feat_keys`` into ``feat``, emit
    ``offset`` (`transformpcd.py:10-36`)."""

    def __init__(self, keys, offset_keys_dict=None, stack_keys=(), **kwargs):
        if offset_keys_dict is None:
            offset_keys_dict = dict(offset="coord")
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.stack_keys = stack_keys
        self.offset_keys = offset_keys_dict
        self.kwargs = kwargs

    def __call__(self, data_dict):
        data = {}
        for key in self.keys:
            data[key] = data_dict[key]
        for key in self.stack_keys:
            data[key] = data_dict[key][None, ...]
        for key, value in self.offset_keys.items():
            data[key] = np.array([data_dict[value].shape[0]], dtype=np.int64)
        for name, keys in self.kwargs.items():
            name = name.replace("_keys", "")
            assert isinstance(keys, Sequence)
            data[name] = np.concatenate(
                [np.asarray(data_dict[key], np.float32).reshape(len(data_dict[key]), -1)
                 for key in keys], axis=1
            )
        return data


class CopyPCD:
    def __init__(self, keys_dict=None):
        if keys_dict is None:
            keys_dict = dict(coord="origin_coord", segment="origin_segment")
        self.keys_dict = keys_dict

    def __call__(self, data_dict):
        for key, value in self.keys_dict.items():
            src = data_dict[key]
            data_dict[value] = src.copy() if isinstance(src, np.ndarray) else copy.deepcopy(src)
        return data_dict


class ToTensorPCD:
    """Dtype normalization (numpy stays numpy; device transfer happens at collate)."""

    def __call__(self, data):
        if isinstance(data, str):
            return data
        if isinstance(data, int):
            return np.array([data], dtype=np.int64)
        if isinstance(data, float):
            return np.array([data], dtype=np.float32)
        if isinstance(data, np.ndarray):
            if np.issubdtype(data.dtype, np.bool_):
                return data
            if np.issubdtype(data.dtype, np.integer):
                return data.astype(np.int64)
            if np.issubdtype(data.dtype, np.floating):
                return data.astype(np.float32)
            return data
        if isinstance(data, Mapping):
            return {k: self(v) for k, v in data.items()}
        if isinstance(data, Sequence):
            return [self(v) for v in data]
        raise TypeError(f"type {type(data)} cannot be converted")


class NormalizeColorPCD:
    """color in [0,255] -> [-1,1] (`transformpcd.py:83-88`)."""

    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1
        return data_dict


class NormalizeCoordPCD:
    def __call__(self, data_dict):
        if "coord" in data_dict:
            coord = data_dict["coord"] - np.mean(data_dict["coord"], axis=0)
            m = np.max(np.sqrt(np.sum(coord**2, axis=1)))
            data_dict["coord"] = coord / m
        return data_dict


class PositiveShiftPCD:
    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = data_dict["coord"] - data_dict["coord"].min(0)
        return data_dict


class CenterShiftPCD:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            lo = data_dict["coord"].min(axis=0)
            hi = data_dict["coord"].max(axis=0)
            z = lo[2] if self.apply_z else 0
            shift = np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, z])
            data_dict["coord"] = data_dict["coord"] - shift
        return data_dict


class RandomShiftPCD:
    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0))):
        self.shift = shift

    def __call__(self, data_dict):
        if "coord" in data_dict:
            delta = np.array([np.random.uniform(lo, hi) for lo, hi in self.shift])
            data_dict["coord"] = data_dict["coord"] + delta
        return data_dict


class RandomDropoutPCD:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if random.random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = np.random.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            if "sampled_index" in data_dict:
                idx = np.unique(np.append(idx, data_dict["sampled_index"]))
                mask = np.zeros(len(data_dict["segment"]), dtype=bool)
                mask[data_dict["sampled_index"]] = True
                data_dict["sampled_index"] = np.where(mask[idx])[0]
            _subsample(data_dict, idx)
        return data_dict


def _rotation_matrix(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)


class RandomRotatePCD:
    def __init__(self, angle=None, center=None, axis="z", always_apply=False,
                 p=0.5, keys=()):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.always_apply = always_apply
        self.p = 1 if always_apply else p
        self.center = center
        self.keys = keys

    def __call__(self, data_dict):
        if random.random() > self.p:
            return data_dict
        angle = np.random.uniform(self.angle[0], self.angle[1]) * np.pi
        rot = _rotation_matrix(self.axis, angle)
        center = self.center
        if center is None:
            lo, hi = data_dict["coord"].min(0), data_dict["coord"].max(0)
            center = (lo + hi) / 2
        coord = data_dict["coord"] - center
        data_dict["coord"] = coord @ rot.T + center
        if self.keys:
            T1, R4, T2 = np.eye(4), np.eye(4), np.eye(4)
            T1[:3, 3] = -np.asarray(center)
            R4[:3, :3] = rot
            T2[:3, 3] = np.asarray(center)
            _apply_inverse_to_matrix_keys(data_dict, T2 @ R4 @ T1, self.keys)
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot.T
        return data_dict


class RandomScalePCD:
    def __init__(self, scale=None, anisotropic=False, keys=()):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic
        self.keys = keys

    def __call__(self, data_dict):
        scale = np.random.uniform(
            self.scale[0], self.scale[1], 3 if self.anisotropic else 1
        )
        data_dict["coord"] = data_dict["coord"] * scale
        if self.keys:
            S = np.eye(4)
            S[:3, :3] *= scale
            _apply_inverse_to_matrix_keys(data_dict, S, self.keys)
        if "depth_scale" in data_dict:
            assert not self.anisotropic, "anisotropic not supported yet."
            data_dict["depth_scale"] = data_dict["depth_scale"] * scale
        return data_dict


class RandomFlipPCD:
    def __init__(self, p=0.5, keys=()):
        self.p = p
        self.keys = keys

    def __call__(self, data_dict):
        S = np.eye(4)
        for ax in (0, 1):
            if np.random.rand() < self.p:
                data_dict["coord"][:, ax] = -data_dict["coord"][:, ax]
                S[ax, ax] = -1
                if "normal" in data_dict:
                    data_dict["normal"][:, ax] = -data_dict["normal"][:, ax]
        if self.keys:
            _apply_inverse_to_matrix_keys(data_dict, S, self.keys)
        return data_dict


class RandomJitterPCD:
    def __init__(self, sigma=0.01, clip=0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = np.clip(
                self.sigma * np.random.randn(data_dict["coord"].shape[0], 3),
                -self.clip, self.clip,
            )
            data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


class ClipGaussianJitterPCD:
    def __init__(self, scalar=0.02, store_jitter=False):
        self.scalar = scalar
        self.quantile = 1.96
        self.store_jitter = store_jitter

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = np.random.multivariate_normal(
                np.zeros(3), np.identity(3), data_dict["coord"].shape[0]
            )
            jitter = self.scalar * np.clip(jitter / self.quantile, -1, 1)
            data_dict["coord"] = data_dict["coord"] + jitter
            if self.store_jitter:
                data_dict["jitter"] = jitter
        return data_dict


class ChromaticAutoContrastPCD:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            color = data_dict["color"]
            lo, hi = color.min(0, keepdims=True), color.max(0, keepdims=True)
            scale = 255 / (hi - lo)
            contrast = (color[:, :3] - lo) * scale
            blend = np.random.rand() if self.blend_factor is None else self.blend_factor
            data_dict["color"][:, :3] = (1 - blend) * color[:, :3] + blend * contrast
        return data_dict


class ChromaticTranslationPCD:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            tr = (np.random.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"][:, :3] = np.clip(tr + data_dict["color"][:, :3], 0, 255)
        return data_dict


class ChromaticJitterPCD:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            noise = np.random.randn(data_dict["color"].shape[0], 3) * self.std * 255
            data_dict["color"][:, :3] = np.clip(noise + data_dict["color"][:, :3], 0, 255)
        return data_dict


def _rgb_to_grayscale(color: np.ndarray, num_output_channels: int = 1) -> np.ndarray:
    if color.shape[-1] < 3:
        raise TypeError(f"Input color should have >=3 channels, found {color.shape[-1]}")
    if num_output_channels not in (1, 3):
        raise ValueError("num_output_channels should be either 1 or 3")
    r, g, b = color[..., 0], color[..., 1], color[..., 2]
    gray = (0.2989 * r + 0.587 * g + 0.114 * b).astype(color.dtype)[..., None]
    if num_output_channels == 3:
        gray = np.broadcast_to(gray, color.shape)
    return gray


class RandomColorGrayScalePCD:
    def __init__(self, p):
        self.p = p

    rgb_to_grayscale = staticmethod(_rgb_to_grayscale)

    def __call__(self, data_dict):
        if np.random.rand() < self.p:
            data_dict["color"] = _rgb_to_grayscale(data_dict["color"], 3)
        return data_dict


def _rgb2hsv(rgb: np.ndarray) -> np.ndarray:
    """rgb in [0,1] -> hsv in [0,1] (torchvision-style, eq-channel safe)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.max(-1), rgb.min(-1)
    eqc = maxc == minc
    cr = maxc - minc
    s = cr / np.where(eqc, 1.0, maxc)
    div = np.where(eqc, 1.0, cr)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    h = (maxc == r) * (bc - gc)
    h = h + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    h = h + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = (h / 6.0 + 1.0) % 1.0
    return np.stack((h, s, maxc), axis=-1)


def _hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    mask = i[..., None] == np.arange(6)
    a1 = np.stack((v, q, p, p, t, v), axis=-1)
    a2 = np.stack((t, v, v, q, p, p), axis=-1)
    a3 = np.stack((p, p, t, v, v, q), axis=-1)
    rgb = np.stack(
        [(mask * a).sum(-1) for a in (a1, a2, a3)], axis=-1
    )
    return rgb.astype(hsv.dtype)


class RandomColorJitterPCD:
    """torchvision-style brightness/contrast/saturation/hue jitter on point colors
    (`transformpcd.py:396-577`)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=0.95):
        self.brightness = self._check_input(brightness, "brightness")
        self.contrast = self._check_input(contrast, "contrast")
        self.saturation = self._check_input(saturation, "saturation")
        self.hue = self._check_input(
            hue, "hue", center=0, bound=(-0.5, 0.5), clip_first_on_zero=False
        )
        self.p = p

    @staticmethod
    def _check_input(value, name, center=1, bound=(0, float("inf")),
                     clip_first_on_zero=True):
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"If {name} is a single number, it must be non negative.")
            value = [center - float(value), center + float(value)]
            if clip_first_on_zero:
                value[0] = max(value[0], 0.0)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            if not bound[0] <= value[0] <= value[1] <= bound[1]:
                raise ValueError(f"{name} values should be between {bound}")
        else:
            raise TypeError(f"{name} should be a number or a pair.")
        if value[0] == value[1] == center:
            value = None
        return value

    @staticmethod
    def blend(color1, color2, ratio):
        return (float(ratio) * color1 + (1.0 - float(ratio)) * color2).clip(0, 255.0).astype(color1.dtype)

    def adjust_brightness(self, color, factor):
        return self.blend(color, np.zeros_like(color), factor)

    def adjust_contrast(self, color, factor):
        mean = np.mean(_rgb_to_grayscale(color))
        return self.blend(color, mean, factor)

    def adjust_saturation(self, color, factor):
        return self.blend(color, _rgb_to_grayscale(color), factor)

    def adjust_hue(self, color, factor):
        if not -0.5 <= factor <= 0.5:
            raise ValueError(f"hue_factor ({factor}) is not in [-0.5, 0.5].")
        dtype = color.dtype
        hsv = _rgb2hsv(color / 255.0)
        hsv[..., 0] = (hsv[..., 0] + factor) % 1.0
        return (_hsv2rgb(hsv) * 255.0).astype(dtype)

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        order = np.random.permutation(4)
        b = None if self.brightness is None else np.random.uniform(*self.brightness)
        c = None if self.contrast is None else np.random.uniform(*self.contrast)
        s = None if self.saturation is None else np.random.uniform(*self.saturation)
        h = None if self.hue is None else np.random.uniform(*self.hue)
        for fn_id in order:
            if fn_id == 0 and b is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_brightness(data_dict["color"], b)
            elif fn_id == 1 and c is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_contrast(data_dict["color"], c)
            elif fn_id == 2 and s is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_saturation(data_dict["color"], s)
            elif fn_id == 3 and h is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_hue(data_dict["color"], h)
        return data_dict


class HueSaturationTranslationPCD:
    """colorsys-style hue/saturation perturbation (`transformpcd.py:579-644`).
    The reference's __call__ NameErrors on `HueSaturationTranslation`; fixed here."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, data_dict):
        if "color" in data_dict:
            hsv = _rgb2hsv(data_dict["color"][:, :3] / 255.0)
            hue_val = (np.random.rand() - 0.5) * 2 * self.hue_max
            sat_ratio = 1 + (np.random.rand() - 0.5) * 2 * self.saturation_max
            hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
            hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
            data_dict["color"][:, :3] = np.clip(_hsv2rgb(hsv) * 255.0, 0, 255)
        return data_dict


class RandomColorDropPCD:
    def __init__(self, p=0.2, color_augment=0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict

    def __repr__(self):
        return f"RandomColorDrop(color_augment: {self.color_augment}, p: {self.p})"


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A vector hash over integer coordinate rows (`transformpcd.py:779-793`)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.full(arr.shape[0], np.uint64(14695981039346656037), dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Row-major ravel of min-shifted integer coordinates (`transformpcd.py:760-776`)."""
    assert arr.ndim == 2
    arr = arr - arr.min(0)
    arr = arr.astype(np.uint64)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


class GridSamplePCD:
    """Voxel-grid deduplication (`transformpcd.py:662-793`).

    train mode: keep one random point per voxel; test mode: return the full
    partition as a list of parts (part i holds the i-th point of every voxel,
    wrapping around).
    """

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train",
                 keys=("coord", "color", "normal", "segment"),
                 return_grid_coord=False, return_min_coord=False,
                 return_displacement=False, project_displacement=False):
        self.grid_size = grid_size
        self.hash = fnv_hash_vec if hash_type == "fnv" else ravel_hash_vec
        assert mode in ["train", "test"]
        self.mode = mode
        self.keys = keys
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord
        self.return_displacement = return_displacement
        self.project_displacement = project_displacement

    def _displacement(self, scaled_coord, grid_coord, data_dict):
        disp = scaled_coord - grid_coord - 0.5
        if self.project_displacement:
            disp = np.sum(disp * data_dict["normal"], axis=-1, keepdims=True)
        return disp

    def __call__(self, data_dict):
        assert "coord" in data_dict
        mode = data_dict.get("mode", self.mode)
        assert mode in ["train", "test"]
        scaled_coord = data_dict["coord"] / np.array(self.grid_size)
        grid_coord = np.floor(scaled_coord).astype(int)
        min_coord = grid_coord.min(0) * np.array(self.grid_size)
        grid_coord = grid_coord - grid_coord.min(0)

        # fused native path (hash + sort + segment + pick in one C++ pass,
        # `native/pcm_native.cpp`); numpy below is the reference-faithful
        # fallback
        if (mode == "train" and self.hash is fnv_hash_vec
                and "sampled_index" not in data_dict):
            from pointcloudmatters_tpu_torch.data import native

            idx_native = native.grid_subsample_train(
                grid_coord, seed=int(np.random.randint(0, 2**31 - 1))
            )
            if idx_native is not None:
                if self.return_grid_coord:
                    data_dict["grid_coord"] = grid_coord[idx_native]
                if self.return_min_coord:
                    data_dict["min_coord"] = min_coord.reshape([1, 3])
                if self.return_displacement:
                    data_dict["displacement"] = self._displacement(
                        scaled_coord, grid_coord, data_dict
                    )[idx_native]
                for key_name in self.keys:
                    data_dict[key_name] = data_dict[key_name][idx_native]
                return data_dict

        key = self.hash(grid_coord)
        idx_sort = np.argsort(key)
        key_sort = key[idx_sort]
        _, inverse, count = np.unique(key_sort, return_inverse=True, return_counts=True)
        voxel_starts = np.cumsum(np.insert(count, 0, 0)[0:-1])

        if mode == "train":
            pick = np.random.randint(0, count.max(), count.size) % count
            idx_unique = idx_sort[voxel_starts + pick]
            if "sampled_index" in data_dict:
                idx_unique = np.unique(np.append(idx_unique, data_dict["sampled_index"]))
                mask = np.zeros(len(data_dict["segment"]), dtype=bool)
                mask[data_dict["sampled_index"]] = True
                data_dict["sampled_index"] = np.where(mask[idx_unique])[0]
            if self.return_grid_coord:
                data_dict["grid_coord"] = grid_coord[idx_unique]
            if self.return_min_coord:
                data_dict["min_coord"] = min_coord.reshape([1, 3])
            if self.return_displacement:
                data_dict["displacement"] = self._displacement(
                    scaled_coord, grid_coord, data_dict
                )[idx_unique]
            for key_name in self.keys:
                data_dict[key_name] = data_dict[key_name][idx_unique]
            return data_dict

        # test mode: full partition
        data_part_list = []
        for i in range(count.max()):
            idx_part = idx_sort[voxel_starts + i % count]
            data_part = dict(index=idx_part)
            if self.return_grid_coord:
                data_part["grid_coord"] = grid_coord[idx_part]
            if self.return_min_coord:
                data_part["min_coord"] = min_coord.reshape([1, 3])
            if self.return_displacement:
                data_dict["displacement"] = self._displacement(
                    scaled_coord, grid_coord, data_dict
                )[idx_part]
            for key_name in data_dict.keys():
                if key_name in self.keys:
                    data_part[key_name] = data_dict[key_name][idx_part]
                else:
                    data_part[key_name] = data_dict[key_name]
            data_part_list.append(data_part)
        return data_part_list

    # kept as staticmethods for API parity
    ravel_hash_vec = staticmethod(ravel_hash_vec)
    fnv_hash_vec = staticmethod(fnv_hash_vec)


class ShufflePointPCD:
    def __call__(self, data_dict):
        assert "coord" in data_dict
        idx = np.arange(data_dict["coord"].shape[0])
        np.random.shuffle(idx)
        return _subsample(data_dict, idx)


class ComposePCD:
    """Sequential transform composition; outside train mode, transforms whose
    class name contains rand/jitter/shuffle are skipped (reference quirk,
    `transformpcd.py:818-833`)."""

    def __init__(self, transforms=None):
        self.transforms = transforms or []

    def __call__(self, data_dict, mode="train"):
        for t in self.transforms:
            name = t.__class__.__name__.lower()
            if mode != "train" and any(s in name for s in ("rand", "jitter", "shuffle")):
                continue
            data_dict = t(data_dict)
            if data_dict is None:
                return None
        return data_dict

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"
