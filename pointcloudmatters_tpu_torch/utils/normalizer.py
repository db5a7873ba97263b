"""Linear normalizers (port of ``pointcloudmatters_tpu/utils/normalizer.py``).

Parameters are numpy arrays, as in JAX, so a normalizer's ``state_dict`` is
the JAX one's and checkpoints carry it in their extras either way.
``normalize`` and ``unnormalize`` take numpy arrays and tensors: on a tensor
the constants become f32 tensors on its device (copied there once and kept,
so that a training step copies nothing from the host), and a bf16 input
comes out in f32, as JAX promotes a bf16 array times an f32 constant.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SingleFieldLinearNormalizer",
    "LinearNormalizer",
    "array_to_stats",
    "get_range_normalizer_from_stat",
    "get_image_range_normalizer",
    "get_identity_normalizer_from_stat",
]


def array_to_stats(arr: np.ndarray) -> dict:
    arr = np.asarray(arr).reshape(-1, arr.shape[-1])
    return {"min": arr.min(0), "max": arr.max(0), "mean": arr.mean(0), "std": arr.std(0)}


class SingleFieldLinearNormalizer:
    """x_norm = x * scale + offset."""

    def __init__(self, scale, offset, input_stats: dict | None = None):
        self.scale = np.asarray(scale, np.float32)
        self.offset = np.asarray(offset, np.float32)
        self.input_stats = {k: np.asarray(v, np.float32) for k, v in (input_stats or {}).items()}
        self._on_device: dict = {}

    def _operands(self, x):
        """(scale, offset) as operands of ``x``: f32 tensors on its device,
        or the numpy arrays themselves."""
        if not isinstance(x, torch.Tensor):
            return self.scale, self.offset
        if x.device not in self._on_device:
            self._on_device[x.device] = (torch.from_numpy(self.scale).to(x.device),
                                         torch.from_numpy(self.offset).to(x.device))
        return self._on_device[x.device]

    @classmethod
    def create_manual(cls, scale, offset, input_stats_dict=None):
        return cls(scale, offset, input_stats_dict)

    @classmethod
    def create_identity(cls, dtype=np.float32):
        return cls(np.ones(1, dtype), np.zeros(1, dtype),
                   {"min": np.full(1, -1.0), "max": np.ones(1),
                    "mean": np.zeros(1), "std": np.ones(1)})

    @classmethod
    def create_fit(cls, data, mode="limits", output_max=1.0, output_min=-1.0,
                   range_eps=1e-4, fit_offset=True):
        stat = array_to_stats(np.asarray(data))
        if mode == "limits":
            return get_range_normalizer_from_stat(
                stat, output_max=output_max, output_min=output_min, range_eps=range_eps)
        if mode == "gaussian":
            # the unbiased std; near-constant dims get scale 1
            arr = np.asarray(data, np.float32).reshape(-1, np.asarray(data).shape[-1])
            std = arr.std(0, ddof=1) if arr.shape[0] > 1 else np.zeros(arr.shape[1])
            stat = dict(stat, std=std.astype(np.float32))
            scale = 1.0 / np.where(std < range_eps, 1.0, std)
            offset = -stat["mean"] * scale if fit_offset else np.zeros_like(std)
            return cls(scale, offset, stat)
        raise ValueError(mode)

    def normalize(self, x):
        scale, offset = self._operands(x)
        return x * scale + offset

    def unnormalize(self, x):
        scale, offset = self._operands(x)
        return (x - offset) / scale

    def __call__(self, x):
        return self.normalize(x)

    def state_dict(self) -> dict:
        return {"scale": self.scale, "offset": self.offset,
                "input_stats": dict(self.input_stats)}

    @classmethod
    def from_state_dict(cls, state: dict) -> "SingleFieldLinearNormalizer":
        return cls(_numpy(state["scale"]), _numpy(state["offset"]),
                   {k: _numpy(v) for k, v in (state.get("input_stats") or {}).items()})


def _numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class LinearNormalizer:
    """Per-field normalizers by key; ``state_dict`` is a nested dict of
    arrays, which a checkpoint's extras keep."""

    def __init__(self):
        self.params: dict[str, SingleFieldLinearNormalizer] = {}

    def __setitem__(self, key: str, value: SingleFieldLinearNormalizer):
        self.params[key] = value

    def __getitem__(self, key: str) -> SingleFieldLinearNormalizer:
        return self.params[key]

    def __contains__(self, key: str) -> bool:
        return key in self.params

    def keys(self):
        return self.params.keys()

    def fit(self, data: dict, **kwargs):
        for key, value in data.items():
            self.params[key] = SingleFieldLinearNormalizer.create_fit(value, **kwargs)

    def normalize(self, x):
        if isinstance(x, dict):
            return {k: self.params[k].normalize(v) for k, v in x.items() if k in self.params}
        return self.params["_default"].normalize(x)

    def unnormalize(self, x):
        if isinstance(x, dict):
            return {k: self.params[k].unnormalize(v) for k, v in x.items() if k in self.params}
        return self.params["_default"].unnormalize(x)

    def __call__(self, x):
        return self.normalize(x)

    def get_input_stats(self) -> dict:
        return {k: dict(v.input_stats) for k, v in self.params.items()}

    def state_dict(self) -> dict:
        return {k: v.state_dict() for k, v in self.params.items()}

    @classmethod
    def from_state_dict(cls, state: dict) -> "LinearNormalizer":
        """From a ``state_dict`` of numpy arrays, or of tensors (a
        checkpoint's extras)."""
        out = cls()
        for k, v in state.items():
            out.params[k] = SingleFieldLinearNormalizer.from_state_dict(v)
        return out


def get_range_normalizer_from_stat(stat, output_max=1, output_min=-1, range_eps=1e-4):
    """[-1, 1] range normalizer; near-constant dims map to the output
    centre."""
    input_max = np.asarray(stat["max"], np.float32)
    input_min = np.asarray(stat["min"], np.float32)
    input_range = input_max - input_min
    ignore = input_range < range_eps
    input_range = np.where(ignore, output_max - output_min, input_range)
    scale = (output_max - output_min) / input_range
    offset = output_min - scale * input_min
    offset = np.where(ignore, (output_max + output_min) / 2 - input_min, offset)
    return SingleFieldLinearNormalizer.create_manual(scale, offset, stat)


def get_image_range_normalizer():
    """[0, 1] image -> [-1, 1]."""
    stat = {"min": np.zeros(1, np.float32), "max": np.ones(1, np.float32),
            "mean": np.full(1, 0.5, np.float32),
            "std": np.full(1, np.sqrt(1 / 12), np.float32)}
    return SingleFieldLinearNormalizer.create_manual(
        np.array([2.0], np.float32), np.array([-1.0], np.float32), stat)


def get_identity_normalizer_from_stat(stat):
    return SingleFieldLinearNormalizer.create_manual(
        np.ones_like(np.asarray(stat["min"], np.float32)),
        np.zeros_like(np.asarray(stat["min"], np.float32)), stat)
