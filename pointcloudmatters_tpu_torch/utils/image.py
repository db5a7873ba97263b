"""Image resize as ``jax.image.resize`` computes it, for channel-last images.

``resize(x, (H, W), method)`` takes ``(..., h, w, C)`` and returns
``(..., H, W, C)`` for ``method`` ``"bilinear"`` or ``"bicubic"``, up or
down. As ``jax.image.resize`` (``scale_and_translate`` with no translation,
``antialias=True``), each resized axis gets an (in, out) weight matrix built
in f32 from half-centred pixel positions:

- the kernel is the triangle (bilinear) or Keys' cubic with a = -0.5
  (bicubic), stretched by in / out when downsampling (the antialiasing
  filter) and not when upsampling;
- each output's weights are divided by their sum (left at zero where the
  sum is below 1000 float32 eps), and an output whose sample position lies
  outside the input is zero;
- the matrix is cast to the image's type and contracted with it, one axis
  after the other; an axis of unchanged size is not touched.

XLA compiles ``jax.image.resize`` on the CPU with multiply-adds contracted
into fused ones (one rounding), so the sample positions and the cubic's
polynomials are formed here as products and sums rounded once (in f64, then
to f32): a separately rounded product moves a weight by up to an f32 ulp of
the sample position (7.6e-6 at 128 pixels), fused ones agree to 5e-7.

``F.interpolate`` is not a stand-in: its bicubic kernel takes a = -0.75,
and it does not antialias when downsampling.

The matrices are built on the image's device from its sizes alone (no copy
from the host) and kept for reuse.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["resize", "resize_weights"]

_CACHE: dict = {}


def _fma(a, b, c: float) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (the f64 product of two f32 is exact)."""
    return (a.double() * b.double() + c).float()


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    near = _fma(_fma(torch.full_like(x, 1.5), x, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(torch.full_like(x, -0.5), x, 2.5), x, -4.0), x, 2.0)
    return torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))


_KERNELS = {"bilinear": _triangle, "linear": _triangle, "bicubic": _keys_cubic,
            "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str,
                   device=None) -> torch.Tensor:
    """The (in_size, out_size) f32 weights of one axis (module doc), as
    ``jax._src.image.scale.compute_weight_mat`` builds them."""
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r}: one of {sorted(_KERNELS)}")
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)  # in double, then rounded to f32 as JAX's
    inv_scale_f32 = torch.full((), inv_scale, dtype=f32, device=device)
    kernel_scale = torch.clamp_min(inv_scale_f32, 1.0)
    sample = _fma(torch.arange(out_size, dtype=f32, device=device) + 0.5, inv_scale_f32, -0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    weights = _KERNELS[method](x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _weights(in_size: int, out_size: int, method: str, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    key = (in_size, out_size, method, dtype, device)
    if key not in _CACHE:
        _CACHE[key] = resize_weights(in_size, out_size, method, device).to(dtype)
    return _CACHE[key]


def resize(x: torch.Tensor, size: Sequence[int], method: str) -> torch.Tensor:
    """``(..., h, w, C)`` -> ``(..., size[0], size[1], C)`` (module doc)."""
    H, W = size
    h, w = x.shape[-3], x.shape[-2]
    if h != H:
        x = torch.einsum("...hwc,hk->...kwc", x, _weights(h, H, method, x.dtype, x.device))
    if w != W:
        x = torch.einsum("...hwc,wk->...hkc", x, _weights(w, W, method, x.dtype, x.device))
    return x
