"""Shared NN building blocks (port of
``pointcloudmatters_tpu/models/components/nn_utils.py``).

Parameter and buffer names are the JAX package's (``scale``/``bias``
parameters, ``mean``/``var`` running statistics), so converted checkpoints
map one to one.

Training follows the JAX modules exactly: batch statistics over the valid
elements (a masked count, single-pass ``E[x^2] - mean^2`` clamped at 0),
gradients through the statistics, running statistics updated in place with
torch momentum and the unbiased variance. Random draws (dropout bits, VAE
noise) come from an explicit ``torch.Generator``; no global RNG is read.

Under bf16 compute (parameters and activations in bf16, running statistics
in f32, as the JAX trainer's mixed precision casts them) the dtype flow is
the JAX modules': statistics summed in f32 from the bf16 values (squares
taken in f32, as XLA takes them inside its fused reductions), the
per-channel affine folded in f32 from the bf16 parameters and applied in
bf16 (``nn_utils.py:129-135, 291-297`` of the JAX package), dropout scales
by a factor rounded to the activations' type.

Data parallelism: in training, the batch norms sum their statistics'
totals and counts over a process group (:func:`~pointcloudmatters_tpu_torch.
utils.dist.all_reduce_sum`, through which gradients flow) before they form
the mean and variance, so that every rank normalises by the global batch's
statistics and updates its running statistics alike, as the JAX modules'
statistics are global under GSPMD. ``sync_batchnorm`` is not consulted: the
JAX trainer accepts the key and its statistics are global whatever it says.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.ops.fused_builder import (
    fused_builder_supported,
    grouped_stats_data,
    sum_sq_f32,
)
from pointcloudmatters_tpu_torch.ops.oneshot_attention import rounded_scalar
from pointcloudmatters_tpu_torch.ops.pointops import (
    farthest_point_sampling_padded,
    gather_rows_padded,
    knn_query_padded,
)
from pointcloudmatters_tpu_torch.utils import dist

__all__ = [
    "get_sinusoid_encoding_table",
    "reparametrize",
    "activation_fn",
    "MaskedBatchNorm",
    "GroupedBNReluMax",
    "fps_indices",
    "group_tokens",
    "FrozenBatchNorm",
    "BitsDropout",
    "MLP",
]


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> torch.Tensor:
    """(1, n_position, d_hid) interleaved sin/cos table, f32."""
    position = np.arange(n_position)[:, None]
    hid_j = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid_j // 2) / d_hid)
    table = np.where(hid_j % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table[None].astype(np.float32))


def reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """VAE reparameterisation ``mu + exp(logvar / 2) * eps``, eps standard
    normal from ``generator`` (on mu's device)."""
    std = torch.exp(0.5 * logvar)
    eps = torch.randn(std.shape, generator=generator, device=std.device,
                      dtype=std.dtype)
    return mu + std * eps


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry; ``gelu`` is the tanh form, as ``jax.nn.gelu``."""
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "glu": lambda x: F.glu(x, dim=-1),
        "silu": F.silu,
        "mish": lambda x: x * torch.tanh(F.softplus(x)),
    }
    if name not in table:
        raise RuntimeError(f"activation should be one of {sorted(table)}, not {name}.")
    return table[name]


class _RunningNorm(nn.Module):
    """Variables of a batch norm over the last axis: parameters
    ``scale``/``bias``, running ``mean``/``var``; ``momentum`` is the torch
    convention (``new = (1 - m) old + m batch``), as in the JAX modules.

    ``group`` is the process group whose ranks' batches make one batch (the
    JAX modules' ``axis_name``): None for the default group, when one is
    initialised."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 group=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.group = group
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def statistics(self, total: torch.Tensor, total_sq: torch.Tensor,
                   count) -> tuple[torch.Tensor, torch.Tensor]:
        """Batch (mean, biased var) from f32 sums over ``count`` elements,
        each summed over the group's ranks first; updates the running
        statistics in place (no gradient) with the unbiased variance, as
        ``nn_utils.py:113-127`` of the JAX package."""
        if not torch.is_tensor(count):  # filled on the device: no host copy
            count = torch.full((), float(count), dtype=torch.float32, device=total.device)
        if self.group is not None or dist.is_initialized():
            d = total.shape[0]
            summed = dist.all_reduce_sum(torch.cat([total, total_sq, count.reshape(1)]),
                                         self.group)
            total, total_sq, count = summed[:d], summed[d:2 * d], summed[2 * d]
        count = torch.clamp_min(count, 1.0)
        mean = total / count
        var = torch.clamp_min(total_sq / count - mean * mean, 0.0)
        with torch.no_grad():
            unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
            self.mean.copy_((1.0 - self.momentum) * self.mean + self.momentum * mean)
            self.var.copy_((1.0 - self.momentum) * self.var + self.momentum * unbiased)
        return mean, var

    def affine(self, mean: torch.Tensor, var: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(eff_scale, eff_bias): ``eff_scale = scale / sqrt(var + eps)``."""
        eff_scale = self.scale * torch.rsqrt(var + self.eps)
        return eff_scale, self.bias - mean * eff_scale


class MaskedBatchNorm(_RunningNorm):
    """Batch norm over the valid elements, ``y = x * eff_scale + eff_bias``.

    ``mask`` (broadcastable to ``x.shape[:-1]``, True = valid) excludes
    padding from the batch statistics; padded activations are normalised
    all the same (later layers ignore them). The count is the valid
    elements' (every element's without a mask), summed over the group as
    the totals are."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            dims = tuple(range(x.ndim - 1))
            if mask is None:
                count = float(np.prod(x.shape[:-1]))
                total = x.sum(dim=dims, dtype=torch.float32)
                total_sq = sum_sq_f32(x, dims)
            else:
                m = mask.to(x.dtype)[..., None]
                count = mask.to(torch.float32).sum()
                total = (x * m).sum(dim=dims, dtype=torch.float32)
                total_sq = sum_sq_f32(x * m, dims)
            mean, var = self.statistics(total, total_sq, count)
        eff_scale, eff_bias = self.affine(mean, var)
        return x * eff_scale.to(x.dtype) + eff_bias.to(x.dtype)


class GroupedBNReluMax(_RunningNorm):
    """Point-token builder ``max_k(relu(BN(where(hole, 0, g[nn] - h))))``.

    BN is one per-channel affine and ReLU is monotone, so the pool needs only
    the per-token max of the gathered rows where the effective scale is
    ``>= 0`` and their min where it is negative. A hole (``nn_idx < 0``)
    contributes an exact-zero row to the pool and to the batch statistics,
    whose count is every (token, neighbour) slot, holes included (the
    reference quirk), summed over the group as the totals are. Same
    variables as :class:`MaskedBatchNorm`.

    Two routes to the pooled statistics, as in the JAX module: ``"xla"``,
    plain torch over the gathered (B, M, K, D) rows, differentiable in g and
    h; and ``"fused_data"``, :func:`~pointcloudmatters_tpu_torch.ops.
    fused_builder.grouped_stats_data` (kernels 5 and 6 on the card) for
    source rows that are data. :meth:`resolve_impl` picks between them."""

    @staticmethod
    def resolve_impl(n: int, m: int, k: int, d: int, dtype: torch.dtype,
                     device: torch.device) -> str:
        """``"fused"`` where the data-source kernels take the call: a CUDA
        device, bf16 activations (the kernels are bf16-native; under f32
        they would change the precision) and shapes that pass
        ``fused_builder_supported``; else ``"xla"`` (the CPU always, as the
        JAX module off the TPU). ``PCM_BUILDER_IMPL=xla|fused`` overrides;
        ``fused`` raises where the kernels cannot take the call."""
        forced = os.environ.get("PCM_BUILDER_IMPL", "auto")
        if forced == "xla":
            return "xla"
        ok = (torch.device(device).type == "cuda" and dtype == torch.bfloat16
              and fused_builder_supported(n, m, k, d))
        if forced == "fused":
            if not ok:
                raise ValueError(
                    f"PCM_BUILDER_IMPL=fused but shapes/device unsupported: "
                    f"N={n} M={m} K={k} D={d} dtype={dtype} device={device}")
            return "fused"
        return "fused" if ok else "xla"

    def forward(self, g: Optional[torch.Tensor], h: torch.Tensor, nn_idx: torch.Tensor,
                use_running_average: bool = True, *, src: Optional[torch.Tensor] = None,
                W: Optional[torch.Tensor] = None, impl: str = "xla") -> torch.Tensor:
        """g: (B, N, D) projected source rows; h: (B, M, D) projected query
        offsets; nn_idx: (B, M, K) into N, -1 = hole -> (B, M, D).

        ``impl="fused_data"`` takes the unprojected data rows ``src``
        (B, N, Cin), which get no gradient, and the projection ``W``
        (Cin, D) instead of g (which may be None)."""
        hole = (nn_idx < 0)[..., None]  # (B, M, K, 1)
        if impl == "fused_data":
            vmax, vmin, total, total_sq = grouped_stats_data(src, W, h, nn_idx)
        elif impl == "xla":
            x = gather_rows_padded(g, nn_idx) - h[:, :, None, :]
            vmax = torch.where(hole, -torch.inf, x).amax(dim=2)
            vmin = torch.where(hole, torch.inf, x).amin(dim=2)
            if not use_running_average:
                xz = torch.where(hole, 0.0, x)
                total = xz.sum(dim=(0, 1, 2), dtype=torch.float32)
                total_sq = sum_sq_f32(xz, (0, 1, 2))
        else:
            raise NotImplementedError(
                f"GroupedBNReluMax impl={impl!r}: the ported routes are 'xla' and "
                f"'fused_data' (the learned-feature 'fused_core' has no call site)")
        any_hole = hole.any(dim=2)  # (B, M, 1)
        # maximum/minimum against zero, not clamp: at a tie the gradient
        # splits 0.5/0.5 as jnp.maximum's does (clamp passes all of it)
        zero = torch.zeros((), dtype=vmax.dtype, device=vmax.device)
        xmax = torch.where(any_hole, torch.maximum(vmax, zero), vmax)
        xmin = torch.where(any_hole, torch.minimum(vmin, zero), vmin)
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = self.statistics(total, total_sq, float(np.prod(nn_idx.shape)))
        eff_scale, eff_bias = self.affine(mean, var)
        eff_scale, eff_bias = eff_scale.to(h.dtype), eff_bias.to(h.dtype)
        sel = torch.where(eff_scale >= 0, xmax, xmin)
        return F.relu(sel * eff_scale + eff_bias)


def fps_indices(coord: torch.Tensor, valid: torch.Tensor, npoints: int,
                fg_mask: Optional[torch.Tensor] = None, bg_ratio: float = 0.0) -> torch.Tensor:
    """(B, npoints) token centres by FPS over the valid points (JAX
    ``act.py:289-303``); with a foreground ``fg_mask``, ``npoints -
    int(npoints * bg_ratio)`` from the valid foreground, then the rest from
    the valid background. FPS keeps its semantics under any mask: it seeds
    at index 0 whether or not point 0 is in the mask, a mask of fewer
    points than asked repeats indices, and an empty one yields 0 throughout."""
    if fg_mask is None:
        return farthest_point_sampling_padded(coord, valid, npoints)
    fg = fg_mask.to(torch.bool)
    n_bg = int(npoints * bg_ratio)
    fg_idx = farthest_point_sampling_padded(coord, valid & fg, npoints - n_bg)
    if n_bg > 0:
        bg_idx = farthest_point_sampling_padded(coord, valid & ~fg, n_bg)
        return torch.cat([fg_idx, bg_idx], dim=1)
    return fg_idx


def group_tokens(linear: nn.Linear, bn: GroupedBNReluMax, coord: torch.Tensor,
                 feat: torch.Tensor, valid: torch.Tensor, npoints: int, nsample: int,
                 fg_mask: Optional[torch.Tensor] = None, bg_ratio: float = 0.0,
                 train: bool = False, feat_is_data: bool = False):
    """The point-cloud token builder of ``ACTPCD`` and ``PCDObsEncoder``
    (their ``pcd_sampling``): FPS centres (:func:`fps_indices`), kNN groups
    of ``nsample`` and ``max_k(relu(bn(linear([xyz[nn] - xyz_c, feat[nn]]))))``
    -> (new_xyz (B, m, 3), tokens (B, m, D), idx (B, m)).

    ``linear`` is bias-free, so the grouped projection is
    ``linear([xyz, feat])[nn] - linear([new_xyz, 0])``: the N source points
    are projected once (JAX ``act.py:305-350``). With ``feat_is_data`` (a
    raw ``pre_sample`` cloud, a frozen backbone's features) the builder may
    take the data-source kernels, as ``GroupedBNReluMax.resolve_impl``
    decides; learned features stay on the plain chain (their backward needs
    the dense dg)."""
    idx = fps_indices(coord, valid, npoints, fg_mask, bg_ratio)
    new_xyz = torch.gather(coord, 1, idx.to(torch.long)[..., None].expand(-1, -1, 3))
    nn_idx, _ = knn_query_padded(new_xyz, coord, valid, nsample)
    zeros_f = feat.new_zeros(new_xyz.shape[:-1] + (feat.shape[-1],))
    src_cat = torch.cat([coord, feat], dim=-1)
    h = linear(torch.cat([new_xyz, zeros_f], dim=-1))
    impl = GroupedBNReluMax.resolve_impl(
        coord.shape[1], nn_idx.shape[1], nn_idx.shape[2], h.shape[-1], h.dtype, h.device,
    ) if feat_is_data else "xla"
    if impl == "fused":
        W = linear.weight.t().to(h.dtype)  # (Cin, D)
        x = bn(None, h, nn_idx, use_running_average=not train, src=src_cat.detach(), W=W,
               impl="fused_data")
    else:
        x = bn(linear(src_cat), h, nn_idx, use_running_average=not train)
    return new_xyz, x, idx


class FrozenBatchNorm(nn.Module):
    """A batch norm whose statistics and affine never train or move (the
    reference's ``FrozenBatchNorm2d``): f32 buffers ``mean``, ``var``,
    ``scale`` and ``bias`` (JAX keeps them in ``batch_stats``, so no
    optimizer sees them), ``y = (x - mean) * rsqrt(var + eps) * scale +
    bias`` in f32, cast to ``dtype`` or to the input's type."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.register_buffer("scale", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.to(torch.float32) - self.mean) * torch.rsqrt(self.var + self.eps)
        return (y * self.scale + self.bias).to(self.dtype or x.dtype)


class BitsDropout(nn.Module):
    """Dropout from uint8 random bits (the JAX module's, ``nn_utils.py:331-368``):
    the rate is quantised to ``threshold = max(1, round(rate * 256))`` of 256,
    an element is kept iff its bits are ``>= threshold``, and survivors are
    scaled by ``256 / (256 - threshold)``. The identity at inference."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        if generator is None:
            raise ValueError("BitsDropout in training needs a generator")
        threshold = max(1, int(round(self.rate * 256)))
        if threshold >= 256:
            return torch.zeros_like(x)
        keep_prob = (256 - threshold) / 256.0
        bits = torch.randint(0, 256, x.shape, generator=generator,
                             device=x.device, dtype=torch.uint8)
        scale = rounded_scalar(1.0 / keep_prob, x.dtype)
        return torch.where(bits >= threshold, x * scale, 0.0)


class MLP(nn.Module):
    """A ReLU MLP head (DETR's): ``num_layers`` linears, ``Dense_<i>`` as
    flax names them, ReLU between. Each computes in ``dtype`` when given,
    else in the promoted type of its input and weights, as flax's ``Dense``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        widths = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            layer = getattr(self, f"Dense_{i}")
            dt = self.dtype or torch.promote_types(x.dtype, layer.weight.dtype)
            x = F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x
