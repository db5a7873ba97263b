"""robomimic's ``CropRandomizer``, channel-last (port of
``pointcloudmatters_tpu/models/components/diffusion_policy/vision/crop_randomizer.py``).

``forward_in`` takes ``num_crops`` random crops of each image in training,
drawn from ``rngs["dropout"]``, and folds them into the batch; at eval it
takes the centre crop, repeated ``num_crops`` times. ``forward_out``
averages the crops' features back to one a row. ``pos_enc`` appends two
channels, each cropped pixel's source row over H and column over W.

Kept as JAX has it: the random crops draw their offsets from
``[0, H - crop_height)`` and ``[0, W - crop_width)``, the upper end
excluded, so the last offset is never taken (``MultiImageObsEncoder``'s
own crops include it). No shipped config instantiates this module.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["crop_image_from_indices", "sample_random_image_crops", "crop_indices",
           "CropRandomizer"]


def crop_image_from_indices(images: torch.Tensor, crop_indices: torch.Tensor,
                            crop_height: int, crop_width: int) -> torch.Tensor:
    """``images (..., H, W, C)`` cropped at ``crop_indices (..., N, 2)``
    (each crop's top-left (h, w)) -> ``(..., N, crop_height, crop_width, C)``."""
    if crop_indices.shape[-1] != 2:
        raise ValueError(f"crop indices (..., N, 2), not {tuple(crop_indices.shape)}")
    *lead, H, W, C = images.shape
    n = crop_indices.shape[-2]
    flat = images.reshape(-1, H, W, C)
    idx = crop_indices.reshape(-1, n, 2).to(torch.long)
    dev = images.device
    rows = idx[..., 0, None] + torch.arange(crop_height, device=dev)  # (B, N, ch)
    cols = idx[..., 1, None] + torch.arange(crop_width, device=dev)   # (B, N, cw)
    b = torch.arange(flat.shape[0], device=dev)[:, None, None, None]
    crops = flat[b, rows[:, :, :, None], cols[:, :, None, :]]
    return crops.reshape(*lead, n, crop_height, crop_width, C)


def crop_indices(generator: torch.Generator, shape: tuple, H: int, W: int, crop_height: int,
                 crop_width: int) -> torch.Tensor:
    """``shape + (2,)`` top-left corners: rows in [0, H - crop_height) and
    columns in [0, W - crop_width), the upper end excluded (0 where the crop
    is the whole side), on the generator's device."""
    dev = generator.device
    tops = torch.randint(0, max(H - crop_height, 1), shape, generator=generator, device=dev)
    lefts = torch.randint(0, max(W - crop_width, 1), shape, generator=generator, device=dev)
    return torch.stack([tops, lefts], dim=-1)


def _positions(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(len(rows), len(cols), 2): each pixel's (row, column) value."""
    ph, pw = torch.meshgrid(rows, cols, indexing="ij")
    return torch.stack([ph, pw], dim=-1)


def sample_random_image_crops(generator: torch.Generator, images: torch.Tensor,
                              crop_height: int, crop_width: int, num_crops: int,
                              pos_enc: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``num_crops`` crops of each image, uniformly placed
    (:func:`crop_indices`): ``(crops (..., N, ch, cw, C [+ 2]), indices
    (..., N, 2))``; with ``pos_enc`` the two position channels are appended
    before cropping."""
    *lead, H, W, C = images.shape
    if pos_enc:
        dt, dev = images.dtype, images.device
        pos = _positions(torch.arange(H, dtype=dt, device=dev) / H,
                         torch.arange(W, dtype=dt, device=dev) / W)
        images = torch.cat([images, pos.expand(*lead, H, W, 2)], dim=-1)
    idx = crop_indices(generator, tuple(lead) + (num_crops,), H, W, crop_height, crop_width)
    return crop_image_from_indices(images, idx, crop_height, crop_width), idx


class CropRandomizer(nn.Module):
    """``forward_in`` / ``forward_out`` around an encoder (module doc);
    ``input_shape`` is (H, W, C)."""

    def __init__(self, input_shape: Sequence[int], crop_height: int, crop_width: int,
                 num_crops: int = 1, pos_enc: bool = False):
        super().__init__()
        self.input_shape = list(input_shape)
        self.crop_height = crop_height
        self.crop_width = crop_width
        self.num_crops = num_crops
        self.pos_enc = pos_enc

    def output_shape_in(self, input_shape: Optional[Sequence[int]] = None) -> list[int]:
        out_c = self.input_shape[-1] + 2 if self.pos_enc else self.input_shape[-1]
        return [self.crop_height, self.crop_width, out_c]

    def output_shape_out(self, input_shape: Sequence[int]) -> list[int]:
        return list(input_shape)

    def forward_in(self, inputs: torch.Tensor, train: bool = False,
                   rngs: Optional[Mapping] = None) -> torch.Tensor:
        """(B, H, W, C) -> (B * N, ch, cw, C [+ 2]): random crops in
        training (``rngs["dropout"]``), the centre crop repeated at eval."""
        B, H, W, C = inputs.shape
        ch, cw = self.crop_height, self.crop_width
        if train:
            if rngs is None or "dropout" not in rngs:
                raise ValueError("CropRandomizer's crops in training need rngs['dropout']")
            crops, _ = sample_random_image_crops(rngs["dropout"], inputs, ch, cw,
                                                 self.num_crops, pos_enc=self.pos_enc)
            return crops.reshape((B * self.num_crops,) + tuple(crops.shape[2:]))
        top, left = (H - ch) // 2, (W - cw) // 2
        out = inputs[:, top:top + ch, left:left + cw, :]
        if self.pos_enc:
            dt, dev = inputs.dtype, inputs.device
            pos = _positions((torch.arange(ch, dtype=dt, device=dev) + top) / H,
                             (torch.arange(cw, dtype=dt, device=dev) + left) / W)
            out = torch.cat([out, pos.expand(B, ch, cw, 2)], dim=-1)
        if self.num_crops > 1:
            out = out.repeat_interleave(self.num_crops, dim=0)
        return out

    def forward_out(self, inputs: torch.Tensor) -> torch.Tensor:
        """(B * N, ...) -> (B, ...), the mean over each row's N crops: their
        sum times 1 / N in the inputs' type, as XLA forms ``jnp.mean``."""
        if self.num_crops <= 1:
            return inputs
        b = inputs.shape[0] // self.num_crops
        crops = inputs.reshape((b, self.num_crops) + tuple(inputs.shape[1:]))
        inv = torch.tensor(1.0 / self.num_crops, dtype=inputs.dtype)
        return crops.sum(dim=1) * inv.to(inputs.device)

    def forward(self, inputs: torch.Tensor, train: bool = False,
                rngs: Optional[Mapping] = None) -> torch.Tensor:
        return self.forward_in(inputs, train=train, rngs=rngs)
