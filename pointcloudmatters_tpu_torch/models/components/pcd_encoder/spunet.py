"""SpUNet, the PonderV2-style sparse 3D UNet (port of
``pointcloudmatters_tpu/models/components/pcd_encoder/spunet.py``).

A k=5 submanifold stem, four stages of a stride-2 down-convolution and
residual ``BasicBlock`` towers, and (unless ``cls_mode``) four inverse
up-convolutions, each concatenated with the skip of its level and followed
by blocks; ``PDBatchNorm`` after every convolution; channels (32, 64, 128,
256, 256, 128, 96, 96) and layers (2, 3, 4, 6, 2, 2, 2, 2) by default. The
sparse machinery is :mod:`pointcloudmatters_tpu_torch.ops.sparse`: one
neighbour map a level, reused by every block there, and the padded length N
of the input at every level, as in JAX, so that the port matches it slot
for slot, padded slots included.

Parameter names are the JAX module's: the convolution planes
(``conv_input_weight``, ``down{s}_weight``, ``up{s}_weight``,
``{enc,dec}{s}_block{i}_{conv1,conv2,proj}``, ``final_weight``) are
parameters of shape (K, Ci, Co), ``final_bias`` one of (num_classes,); a
``PDBatchNorm``'s branches are ``bns.<i>`` (JAX ``bns_<i>``), its FiLM
``modulation`` a ``Linear``, and the condition embedding
``embedding_table`` an ``nn.Embedding``.

:func:`load_ponderv2_weights` maps a PonderV2 checkpoint (``module.backbone.*``
keys, spconv layout) onto the module.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudmatters_tpu_torch.models.components.nn_utils import MaskedBatchNorm
from pointcloudmatters_tpu_torch.ops import sparse as S

__all__ = ["PDBatchNorm", "SpUNet", "load_ponderv2_weights", "ponderv2_state_dict",
           "ponderv2_key", "to_ponderv2_state_dict"]

CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")


class PDBatchNorm(nn.Module):
    """Per-condition decoupled batch norm with an optional adaptive FiLM
    (JAX ``spunet.py:31-73``): momentum 0.01, eps 1e-3. With ``decouple``,
    every condition's branch is computed (in training every branch's running
    statistics move) and the branches are masked by 1/0, so the branches
    not selected get zero gradients, not none. With ``adaptive``,
    ``feat * (1 + scale) + shift`` from ``modulation(silu(context))``.
    ``group`` is the process group the statistics are summed over."""

    def __init__(self, num_features: int, context_channels: int = 256, eps: float = 1e-3,
                 momentum: float = 0.01, conditions: Sequence[str] = CONDITIONS,
                 decouple: bool = True, adaptive: bool = False, affine: bool = True,
                 group=None):
        super().__init__()
        self.conditions = tuple(conditions)
        self.decouple = decouple
        self.adaptive = adaptive
        self.affine = affine  # kept, as in JAX: the branches always carry scale and bias
        if decouple:
            self.bns = nn.ModuleList(
                MaskedBatchNorm(num_features, momentum=momentum, eps=eps, group=group)
                for _ in self.conditions)
        else:
            self.bn = MaskedBatchNorm(num_features, momentum=momentum, eps=eps, group=group)
        if adaptive:
            self.modulation = nn.Linear(context_channels, 2 * num_features)

    def forward(self, feat: torch.Tensor, mask: Optional[torch.Tensor] = None,
                condition: Optional[str] = None, context: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if self.decouple:
            if condition not in self.conditions:
                raise ValueError(f"condition {condition!r} not in {self.conditions}")
            index = self.conditions.index(condition)
            out = 0.0
            for i, bn in enumerate(self.bns):
                branch = bn(feat, mask=mask, use_running_average=not train)
                out = out + branch * (1.0 if i == index else 0.0)
            feat = out
        else:
            feat = self.bn(feat, mask=mask, use_running_average=not train)
        if self.adaptive:
            if context is None:
                raise ValueError("an adaptive PDBatchNorm needs a context")
            shift, scale = self.modulation(F.silu(context)).chunk(2, dim=-1)
            feat = feat * (1.0 + scale) + shift
        return feat


def _plane(k: int, ci: int, co: int) -> nn.Parameter:
    # drawn by entry.init_parameters (truncated normal, std 0.02, as JAX)
    return nn.Parameter(torch.zeros(k, ci, co))


class SpUNet(nn.Module):
    """``forward({"grid_coord": (B, N, 3) int, "feat": (B, N, in_channels),
    "valid": (B, N)}, train)`` -> (B, N, :attr:`num_channels`) per-point
    features over the padded input, or (B, num_channels) in ``cls_mode``
    (the masked mean over the last level's valid voxels). An optional
    ``"condition"`` string picks the batch norms' branch (anything else:
    ``conditions[0]``), an optional ``"context"`` (1, context_channels)
    replaces the condition's embedding. ``dtype`` and ``zero_init`` are the
    config's keys, unused as in JAX; ``pretrained_path`` is read by
    :func:`~pointcloudmatters_tpu_torch.models.components.pretrained.load_pretrained_into`."""

    def __init__(self, in_channels: int, num_classes: int = 0, base_channels: int = 32,
                 context_channels: int = 256,
                 channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2), cls_mode: bool = False,
                 conditions: Sequence[str] = CONDITIONS, zero_init: bool = False,
                 norm_decouple: bool = True, norm_adaptive: bool = True,
                 norm_affine: bool = True, pretrained_path: Optional[str] = None,
                 dtype: Any = None, group=None):
        super().__init__()
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.base_channels = base_channels
        self.channels = tuple(channels)
        self.layers = tuple(layers)
        self.cls_mode = cls_mode
        self.conditions = tuple(conditions)
        self.norm_adaptive = norm_adaptive
        self.zero_init = zero_init
        self.dtype = dtype
        self.pretrained_path = pretrained_path

        def norm(width):
            return PDBatchNorm(width, context_channels=context_channels,
                               conditions=self.conditions, decouple=norm_decouple,
                               adaptive=norm_adaptive, affine=norm_affine, group=group)

        def block(scope, ci, co):
            setattr(self, f"{scope}_conv1", _plane(27, ci, co))
            setattr(self, f"{scope}_bn1", norm(co))
            setattr(self, f"{scope}_conv2", _plane(27, co, co))
            setattr(self, f"{scope}_bn2", norm(co))
            if ci != co:
                setattr(self, f"{scope}_proj", _plane(1, ci, co))
                setattr(self, f"{scope}_proj_bn", norm(co))

        if norm_adaptive:
            self.embedding_table = nn.Embedding(len(self.conditions), context_channels)
        self.conv_input_weight = _plane(125, in_channels, base_channels)
        self.conv_input_bn = norm(base_channels)
        enc_widths = [base_channels]
        for s in range(self.num_stages):
            setattr(self, f"down{s}_weight", _plane(8, enc_widths[-1], self.channels[s]))
            setattr(self, f"down{s}_bn", norm(self.channels[s]))
            for i in range(self.layers[s]):
                block(f"enc{s}_block{i}", self.channels[s], self.channels[s])
            enc_widths.append(self.channels[s])
        width = enc_widths[-1]
        if not cls_mode:
            for s in reversed(range(self.num_stages)):
                dec_c = self.channels[len(self.channels) - 1 - s]
                setattr(self, f"up{s}_weight", _plane(8, width, dec_c))
                setattr(self, f"up{s}_bn", norm(dec_c))
                for i in range(self.layers[len(self.channels) - s - 1]):
                    block(f"dec{s}_block{i}", dec_c + enc_widths[s] if i == 0 else dec_c, dec_c)
                width = dec_c
        if num_classes > 0:
            self.final_weight = _plane(1, width, num_classes)
            self.final_bias = nn.Parameter(torch.zeros(num_classes))

    @property
    def num_stages(self) -> int:
        return len(self.layers) // 2

    @property
    def num_channels(self) -> int:
        if self.num_classes > 0:
            return self.num_classes
        return self.channels[-1] if not self.cls_mode else self.channels[self.num_stages - 1]

    def _norm(self, scope, x, mask, cond):
        return getattr(self, scope)(x, mask=mask, condition=cond["condition"],
                                    context=cond["context"], train=cond["train"])

    def _basic_block(self, scope, x, idx, mask, cond, max_dup):
        """Residual BasicBlock (JAX ``spunet.py:135-160``)."""
        out = S.submconv(x, getattr(self, f"{scope}_conv1"), idx, max_dup)
        out = F.relu(self._norm(f"{scope}_bn1", out, mask, cond))
        out = S.submconv(out, getattr(self, f"{scope}_conv2"), idx, max_dup)
        out = self._norm(f"{scope}_bn2", out, mask, cond)
        residual = x
        if hasattr(self, f"{scope}_proj"):
            residual = torch.matmul(x, getattr(self, f"{scope}_proj")[0].to(x.dtype))
            residual = self._norm(f"{scope}_proj_bn", residual, mask, cond)
        return F.relu(out + residual)

    def forward(self, input_dict: Mapping, train: bool = False) -> torch.Tensor:
        grid_coord = input_dict["grid_coord"].to(torch.int32)
        feat = input_dict["feat"]
        valid = input_dict["valid"].to(torch.bool)
        condition = input_dict.get("condition", self.conditions[0])
        if not isinstance(condition, str):
            condition = self.conditions[0]
        context = input_dict.get("context")
        if context is None and self.norm_adaptive:
            index = self.conditions.index(condition)
            context = self.embedding_table.weight[index:index + 1].to(feat.dtype)
        cond = {"condition": condition, "context": context, "train": train}

        # the input level may repeat a coordinate (max_dup None); every
        # level above holds one representative a parent voxel, at most 8
        # children each (ops/sparse.py)
        x = S.submconv(feat, self.conv_input_weight, S.neighbor_indices(
            grid_coord, valid, S.kernel_offsets_on(5, grid_coord.device)))
        x = F.relu(self._norm("conv_input_bn", x, valid, cond))
        off27 = S.kernel_offsets_on(3, grid_coord.device)
        coords, valids, reps = [grid_coord], [valid], []
        idx27 = [S.neighbor_indices(grid_coord, valid, off27)]
        skips = [x]
        for s in range(self.num_stages):
            parent, rep, new_valid = S.voxel_downsample(coords[-1], valids[-1])
            x = S.strided_downconv(x, getattr(self, f"down{s}_weight"), coords[-1], rep,
                                   valids[-1], None if s == 0 else 8)
            x = F.relu(self._norm(f"down{s}_bn", x, new_valid, cond))
            reps.append(rep)
            coords.append(torch.where(new_valid[..., None], parent, 0))
            valids.append(new_valid)
            idx27.append(S.neighbor_indices(coords[-1], new_valid, off27))
            for i in range(self.layers[s]):
                x = self._basic_block(f"enc{s}_block{i}", x, idx27[-1], new_valid, cond, 1)
            skips.append(x)

        x = skips.pop(-1)
        if not self.cls_mode:
            for s in reversed(range(self.num_stages)):
                max_dup, max_children = (None, None) if s == 0 else (1, 8)
                x = S.inverse_upconv(x, getattr(self, f"up{s}_weight"), coords[s], reps[s],
                                     valids[s], max_children)
                x = F.relu(self._norm(f"up{s}_bn", x, valids[s], cond))
                x = torch.cat([x, skips.pop(-1)], dim=-1)
                for i in range(self.layers[len(self.channels) - s - 1]):
                    x = self._basic_block(f"dec{s}_block{i}", x, idx27[s], valids[s], cond,
                                          max_dup)
            out_valid = valids[0]
        else:
            out_valid = valids[-1]

        if self.num_classes > 0:
            x = torch.matmul(x, self.final_weight[0].to(x.dtype)) + self.final_bias.to(x.dtype)
        if self.cls_mode:
            m = out_valid[..., None].to(x.dtype)
            x = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
        return x


# ---------------------------------------------------------------------------
# PonderV2 checkpoints (JAX spunet.py:278-347)
# ---------------------------------------------------------------------------

def _port_spconv_weight(w: torch.Tensor, k: int) -> torch.Tensor:
    """spconv v2 weights (out, kd, kh, kw, in) -> planes (k^3, in, out) in
    row-major (x, y, z) offset order, the traversal spconv uses."""
    out_c, in_c = w.shape[0], w.shape[-1]
    return w.reshape(out_c, k ** 3, in_c).permute(1, 2, 0)


def ponderv2_state_dict(model: SpUNet, state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The entries of ``model.state_dict()`` that a PonderV2 checkpoint
    (``module.backbone.*`` and ``module.embedding_table.*`` keys) sets,
    under the model's keys, as the checkpoint's tensors (the planes
    permuted from the spconv layout). A key the model needs and the
    checkpoint lacks raises ``KeyError``, as JAX's mapping does."""
    sd = {}
    for key, value in state_dict.items():
        if key.startswith("module.backbone."):
            sd[key[len("module.backbone."):]] = torch.as_tensor(value)
        elif key.startswith("module.embedding_table"):
            sd[key[len("module."):]] = torch.as_tensor(value)
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}

    def put_pdbn(scope: str, prefix: str) -> None:
        for i in range(len(model.conditions)):
            for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                                 ("mean", "running_mean"), ("var", "running_var")):
                out[f"{scope}.bns.{i}.{ours}"] = sd[f"{prefix}.bns.{i}.{theirs}"]
        if f"{prefix}.modulation.1.weight" in sd and f"{scope}.modulation.weight" in target:
            out[f"{scope}.modulation.weight"] = sd[f"{prefix}.modulation.1.weight"]
            out[f"{scope}.modulation.bias"] = sd[f"{prefix}.modulation.1.bias"]

    if "embedding_table.weight" in sd and "embedding_table.weight" in target:
        out["embedding_table.weight"] = sd["embedding_table.weight"]
    out["conv_input_weight"] = _port_spconv_weight(sd["conv_input.conv.weight"], 5)
    put_pdbn("conv_input_bn", "conv_input.bn")
    s = 0
    while f"down{s}_weight" in target:
        out[f"down{s}_weight"] = _port_spconv_weight(sd[f"down.{s}.conv.weight"], 2)
        put_pdbn(f"down{s}_bn", f"down.{s}.bn")
        if f"up{s}_weight" in target:  # cls_mode has no decoder
            out[f"up{s}_weight"] = _port_spconv_weight(sd[f"up.{s}.conv.weight"], 2)
            put_pdbn(f"up{s}_bn", f"up.{s}.bn")
        for prefix, tp in ((f"enc{s}", f"enc.{s}"), (f"dec{s}", f"dec.{s}")):
            i = 0
            while f"{prefix}_block{i}_conv1" in target:
                b, t = f"{prefix}_block{i}", f"{tp}.block{i}"
                out[f"{b}_conv1"] = _port_spconv_weight(sd[f"{t}.conv1.weight"], 3)
                out[f"{b}_conv2"] = _port_spconv_weight(sd[f"{t}.conv2.weight"], 3)
                put_pdbn(f"{b}_bn1", f"{t}.bn1")
                put_pdbn(f"{b}_bn2", f"{t}.bn2")
                if f"{b}_proj" in target:
                    out[f"{b}_proj"] = _port_spconv_weight(sd[f"{t}.proj_conv.weight"], 1)
                    put_pdbn(f"{b}_proj_bn", f"{t}.proj_norm")
                i += 1
        s += 1
    if "final_weight" in target and "final.weight" in sd:
        out["final_weight"] = _port_spconv_weight(sd["final.weight"], 1)
        out["final_bias"] = sd["final.bias"]
    bad = [f"{k}: {tuple(v.shape)} vs {tuple(target[k].shape)}" for k, v in out.items()
           if tuple(v.shape) != tuple(target[k].shape)]
    if bad:
        raise ValueError("PonderV2 checkpoint shape mismatch: " + "; ".join(bad))
    return out


_PONDERV2_KEYS = (  # (the port's key, PonderV2's), applied in order
    (r"^conv_input_weight$", "conv_input.conv.weight"),
    (r"^(down|up)(\d+)_weight$", r"\1.\2.conv.weight"),
    (r"^final_(weight|bias)$", r"final.\1"),
    (r"^conv_input_bn\.", "conv_input.bn."),
    (r"^(down|up)(\d+)_bn\.", r"\1.\2.bn."),
    (r"^(enc|dec)(\d+)_block(\d+)_(conv1|conv2)$", r"\1.\2.block\3.\4.weight"),
    (r"^(enc|dec)(\d+)_block(\d+)_proj$", r"\1.\2.block\3.proj_conv.weight"),
    (r"^(enc|dec)(\d+)_block(\d+)_proj_bn\.", r"\1.\2.block\3.proj_norm."),
    (r"^(enc|dec)(\d+)_block(\d+)_(bn1|bn2)\.", r"\1.\2.block\3.\4."),
    (r"\.modulation\.", ".modulation.1."),
    (r"(bns\.\d+)\.scale$", r"\1.weight"),
    (r"(bns\.\d+)\.mean$", r"\1.running_mean"),
    (r"(bns\.\d+)\.var$", r"\1.running_var"),
)


def ponderv2_key(key: str) -> str:
    """The PonderV2 checkpoint key (``module.backbone.*``, or
    ``module.embedding_table.*``) of one of SpUNet's state-dict keys."""
    for pattern, repl in _PONDERV2_KEYS:
        key = re.sub(pattern, repl, key)
    return ("module." if key.startswith("embedding_table") else "module.backbone.") + key


def to_ponderv2_state_dict(model: SpUNet) -> dict[str, torch.Tensor]:
    """``model``'s weights as a PonderV2 checkpoint holds them: PonderV2's
    keys, the planes in spconv's (out, k, k, k, in) layout (the inverse of
    :func:`ponderv2_state_dict`)."""
    out = {}
    for key, value in model.state_dict().items():
        value = value.detach().cpu()
        if value.ndim == 3:  # (K, Ci, Co) -> (Co, k, k, k, Ci)
            k = round(value.shape[0] ** (1 / 3))
            value = value.permute(2, 0, 1).reshape(value.shape[2], k, k, k, value.shape[1])
        out[ponderv2_key(key)] = value.contiguous()
    return out


@torch.no_grad()
def load_ponderv2_weights(model: SpUNet, state_dict: Mapping) -> None:
    """Copy a PonderV2 checkpoint into ``model`` in place
    (:func:`ponderv2_state_dict`); the entries it does not set keep their
    values."""
    own = model.state_dict()
    for key, value in ponderv2_state_dict(model, state_dict).items():
        own[key].copy_(value.to(own[key].dtype))

