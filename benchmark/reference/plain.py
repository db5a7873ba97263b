"""Plain PyTorch pieces of the reference models: point sampling and
neighbours, PointNet, the token grouping, batch norms over valid points,
attention with its dropout masks, the optimizer and its schedule.

Every function takes parameters from a ``{name: tensor}`` dict keyed by the
port's ``state_dict`` names (the benchmark hands both sides the same
tensors) and runs in the type it is given: f32, or bf16 where a parameter
dict and a batch were cast as mixed precision casts them. Statistics, the
softmax of the long attention and the optimizer are f32.

Nothing here imports the program. Where a result must follow the program's
random draws, the draw is made the same way from the same seed: the
attention dropout of the long encoder rows keeps an element iff the 32-bit
Philox4x32-10 word of (seed, head, row, column) is at least rate * 2^32 (the
mask the program's attention kernels draw), every other mask and noise is
``torch.rand`` / ``torch.randint`` / ``torch.randn`` from the stream's
generator, in the program's order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
_BIG = 1.0e10


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a host float."""
    return float(torch.tensor(value, dtype=dtype))


def linear(x: torch.Tensor, P: dict, name: str) -> torch.Tensor:
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def layer_norm(x: torch.Tensor, P: dict, name: str, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


# --------------------------------------------------------------------------
# batch norms: statistics over the valid elements, in f32
# --------------------------------------------------------------------------
def _affine(x, scale, bias, mean, var, eps):
    eff_scale = scale * torch.rsqrt(var + eps)
    eff_bias = bias - mean * eff_scale
    return x * eff_scale.to(x.dtype) + eff_bias.to(x.dtype)


def batch_stats(x: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """(mean, biased var) over every axis but the last, f32, the elements
    where ``mask`` is False left out (the count is the valid elements')."""
    dims = tuple(range(x.ndim - 1))
    if mask is None:
        count = torch.tensor(float(np.prod(x.shape[:-1])), device=x.device)
    else:
        x = x * mask.to(x.dtype)[..., None]
        count = mask.to(F32).sum()
    xf = x.to(F32)
    count = torch.clamp_min(count, 1.0)
    mean = xf.sum(dim=dims) / count
    var = torch.clamp_min((xf * xf).sum(dim=dims) / count - mean * mean, 0.0)
    return mean, var


def batch_norm(x, P, name, eps, train, mask=None, B=None):
    """Training: the batch's statistics; otherwise the running ones (``B``,
    the buffers)."""
    if train:
        mean, var = batch_stats(x, mask)
    else:
        mean, var = B[name + ".mean"], B[name + ".var"]
    return _affine(x, P[name + ".scale"], P[name + ".bias"], mean, var, eps)


# --------------------------------------------------------------------------
# point sampling and neighbours (f32 geometry, ties to the smaller index)
# --------------------------------------------------------------------------
def _sq_norm(p):
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def fps(xyz: torch.Tensor, valid: torch.Tensor, npoints: int) -> torch.Tensor:
    """Farthest point sampling from index 0 over the valid points, the
    distance ``|a|^2 + |b|^2 - 2 a.b`` elementwise; (B, npoints) int64."""
    xyz = xyz.to(F32)
    B, N, _ = xyz.shape
    x0, x1, x2 = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    x_sq = _sq_norm(xyz)
    dist = torch.where(valid, _BIG, -1.0)
    col = torch.arange(N, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    out = torch.zeros((B, npoints), dtype=torch.long, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    for i in range(1, npoints):
        d = x_sq + x_sq[rows, last][:, None] - 2.0 * (
            x0 * x0[rows, last][:, None] + x1 * x1[rows, last][:, None]
            + x2 * x2[rows, last][:, None])
        dist = torch.where(valid, torch.minimum(dist, d), dist)
        top = dist.amax(dim=1, keepdim=True)
        last = torch.where(dist >= top, col, N).amin(dim=1)
        out[:, i] = last
    return out


def knn(q: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor, k: int,
        rows: int = 512) -> torch.Tensor:
    """The k nearest valid points of each query, ascending, ties to the
    smaller index, -1 where a cloud has fewer; (B, M, k) int64. One cloud
    and ``rows`` queries at a time."""
    q, xyz = q.to(F32), xyz.to(F32)
    q_sq, p_sq = _sq_norm(q), _sq_norm(xyz)
    out = []
    for b in range(q.shape[0]):
        parts = []
        for r in range(0, q.shape[1], rows):
            qb = q[b, r:r + rows]
            dot = (qb[:, None, 0] * xyz[b, None, :, 0] + qb[:, None, 1] * xyz[b, None, :, 1]
                   + qb[:, None, 2] * xyz[b, None, :, 2])
            d2 = torch.clamp_min(q_sq[b, r:r + rows, None] + p_sq[b, None] - 2.0 * dot, 0.0)
            d2 = torch.where(valid[b, None], d2, _BIG)
            vals, order = torch.sort(d2, dim=-1, stable=True)
            parts.append(torch.where(vals[:, :k] >= _BIG, -1, order[:, :k]))
        out.append(torch.cat(parts))
    return torch.stack(out)


def gather_points(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C) at idx (B, ...) -> (B, ..., C); -1 reads row 0."""
    B, N, C = values.shape
    flat = idx.clamp_min(0).reshape(B, -1)
    got = torch.gather(values, 1, flat[..., None].expand(-1, -1, C))
    return got.reshape(idx.shape + (C,))


# --------------------------------------------------------------------------
# PointNet and the token grouping
# --------------------------------------------------------------------------
POINTNET_WIDTHS = (64, 64, 64, 128, 512)


def pointnet(P, prefix, feat, valid, train, B=None):
    """Five bias-free linears, each with a batch norm over the valid points
    (eps 1e-3) and a ReLU; then the final linear where the model has one."""
    x = feat
    for i in range(1, len(POINTNET_WIDTHS) + 1):
        x = F.linear(x, P[f"{prefix}.conv{i}.weight"])
        x = F.relu(batch_norm(x, P, f"{prefix}.bn{i}", 1e-3, train, valid, B))
    if f"{prefix}.final.weight" in P:
        x = linear(x, P, f"{prefix}.final")
    return x


def group_tokens(P, lin, bn, coord, feat, valid, npoints, nsample, train, B=None):
    """Tokens of a cloud: FPS centres, their k nearest points, and
    ``max_k relu(bn(W [xyz_nn - xyz_c, feat_nn]))`` with the batch norm over
    every (token, neighbour) slot, a missing neighbour a zero row; ->
    (centres (B, M, 3), tokens (B, M, D))."""
    idx = fps(coord, valid, npoints)
    centres = gather_points(coord, idx)
    nn_idx = knn(centres, coord, valid, nsample)
    W = P[lin + ".weight"]
    g = F.linear(torch.cat([coord, feat], dim=-1), W)
    h = F.linear(torch.cat([centres, feat.new_zeros(centres.shape[:-1] + (feat.shape[-1],))],
                           dim=-1), W)
    x = gather_points(g, nn_idx) - h[:, :, None, :]
    x = torch.where((nn_idx < 0)[..., None], 0.0, x)
    if train:
        mean, var = batch_stats(x)
    else:
        mean, var = B[bn + ".mean"], B[bn + ".var"]
    y = F.relu(_affine(x, P[bn + ".scale"], P[bn + ".bias"], mean, var, 1e-5))
    return centres, y.amax(dim=2)


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------
def sinusoid_table(n_position: int, d_hid: int, device) -> torch.Tensor:
    """(1, n, d) interleaved sin/cos, f32."""
    position = np.arange(n_position)[:, None]
    hid_j = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid_j // 2) / d_hid)
    table = np.where(hid_j % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table[None].astype(np.float32)).to(device)


def coord_embedding_sine(coord: torch.Tensor, hidden_dim: int) -> torch.Tensor:
    """(..., 3) -> (..., hidden_dim) f32: per axis ``hidden_dim // 3``
    features, the sines of the even frequencies then the cosines of the odd
    ones, zero-padded."""
    n = hidden_dim // 3
    idx = torch.arange(n, dtype=F32, device=coord.device)
    dim_t = 10000.0 ** (2 * torch.floor(idx / 2) / n)
    parts = []
    for a in range(3):
        vals = coord[..., a][..., None] / dim_t
        parts += [torch.sin(vals[..., 0::2]), torch.cos(vals[..., 1::2])]
    pos = torch.cat(parts, dim=-1)
    pad = hidden_dim - 3 * n
    if pad:
        pos = torch.cat([pos, pos.new_zeros(pos.shape[:-1] + (pad,))], dim=-1)
    return pos


# --------------------------------------------------------------------------
# dropout and attention
# --------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    a = x * (m >> 16)
    b = x * (m & 0xFFFF)
    return (a + (b >> 16)) >> 16, (((a & 0xFFFF) << 16) + b) & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_keep(seed: int, rate: float, heads: int, rows: int, cols: int, device):
    """(heads, rows, cols) keep mask: word ``j % 4`` of Philox of counter
    ``(j // 4, i, 0, 0)`` and key ``(seed, h)`` at least
    ``min(int(rate * 2^32), 2^32 - 1)``."""
    groups = -(-cols // 4)
    h = torch.arange(heads, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(rows, dtype=torch.int64, device=device)[None, :, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    key0 = torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=device)
    words = torch.broadcast_tensors(*philox4x32_10((g, i, zero, zero), (key0, h)))
    bits = torch.stack(words, dim=-1).reshape(heads, rows, groups * 4)[..., :cols]
    return bits >= min(int(rate * 4294967296.0), 4294967295)


def bits_dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]):
    """Dropout from uint8 bits: keep iff bits >= max(1, round(rate * 256)),
    survivors scaled by 256 / (256 - threshold); the identity without a
    generator (evaluation)."""
    if gen is None or rate == 0.0:
        return x
    threshold = max(1, int(round(rate * 256)))
    bits = torch.randint(0, 256, x.shape, generator=gen, device=x.device, dtype=torch.uint8)
    return torch.where(bits >= threshold, x * rounded(256.0 / (256 - threshold), x.dtype), 0.0)


def dense_attention(q, k, v, mask=None, rate=0.0, gen=None):
    """softmax(q k^T / sqrt(dh)) v over (B, L, H, dh), in the inputs' type;
    ``mask`` (True = attend) sets a logit to the type's minimum; dropout:
    one (Lq, Lk) mask from ``gen`` shared by batch and heads."""
    dt = q.dtype
    s = torch.matmul((q / rounded(math.sqrt(q.shape[-1]), dt)).transpose(1, 2),
                     k.permute(0, 2, 3, 1))
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    if gen is not None and rate > 0.0:
        keep = torch.rand(s.shape[-2:], generator=gen, device=s.device) < 1.0 - rate
        p = p * (keep.to(dt) / rounded(1.0 - rate, dt))
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2)


def _long_core(q, k, v, keep, rate):
    dt = q.dtype
    s = torch.matmul((q * rounded(q.shape[-1] ** -0.5, dt)).to(F32), k.to(F32).transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return torch.matmul(p, v.to(F32)).to(dt)


def long_attention(q, k, v, rate=0.0, seed=0, block=4):
    """Attention over long rows, (B, L, H, dh): scores and softmax in f32
    from the inputs' values, dropout by the Philox mask of ``seed`` (one
    mask a head, shared by the batch), the output in the inputs' type.
    ``block`` samples at a time, each recomputed in the backward pass, so
    that the (L, L) scores of the whole batch never live at once."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    keep = None
    if rate > 0.0:
        keep = philox_keep(seed, rate, qt.shape[1], qt.shape[2], kt.shape[2], q.device)
    outs = [checkpoint(_long_core, qt[b:b + block], kt[b:b + block], vt[b:b + block], keep,
                       rate, use_reentrant=False)
            for b in range(0, qt.shape[0], block)]
    return torch.cat(outs).transpose(1, 2)


def mha(P, name, q_in, k_in, v_in, heads, core):
    """Projections of flax's multi-head attention around ``core``."""
    B, Lq, D = q_in.shape
    split = lambda x: x.view(x.shape[0], x.shape[1], heads, -1)  # noqa: E731
    o = core(split(linear(q_in, P, name + ".query")), split(linear(k_in, P, name + ".key")),
             split(linear(v_in, P, name + ".value")))
    return linear(o.reshape(B, Lq, D), P, name + ".out")


# --------------------------------------------------------------------------
# the optimizer: AdamW (decoupled decay) under OneCycleLR, torch's formulas
# --------------------------------------------------------------------------
def _f32(x):
    return np.float32(x)


def _anneal_cos(start, end, pct):
    return _f32(end) + _f32((start - end) / 2.0) * (np.cos(_f32(math.pi) * pct, dtype=np.float32)
                                                    + _f32(1))


def _cycle(start, peak, end, e1, e2, step):
    s = _f32(step)
    if s <= _f32(e1):
        return float(_anneal_cos(start, peak, np.clip(s / _f32(e1), 0, 1)))
    return float(_anneal_cos(peak, end, np.clip((s - _f32(e1)) / _f32(e2 - e1), 0, 1)))


def one_cycle(step: int, total: int, sched: dict, base_lr: float) -> tuple[float, float]:
    """(learning rate, Adam's beta1) of optimizer step ``step`` (from 0)
    under OneCycleLR: cosine from max_lr / div_factor up to max_lr over
    pct_start of ``total`` steps (at least one), then down to
    max_lr / div_factor / final_div_factor; beta1 from max_momentum down to
    base_momentum and back, on the same phases."""
    e1 = max(sched.get("pct_start", 0.3) * float(total) - 1.0, 1.0)
    e2 = max(float(total) - 1.0, e1 + 1.0)
    peak = float(sched.get("max_lr", base_lr))
    initial = peak / sched.get("div_factor", 25.0)
    lr = _cycle(initial, peak, initial / sched.get("final_div_factor", 1e4), e1, e2, step)
    top = float(sched.get("max_momentum", 0.95))
    beta1 = _cycle(top, float(sched.get("base_momentum", 0.85)), top, e1, e2, step)
    return lr, beta1


class AdamW:
    """torch's AdamW update on f32 tensors: decay ``p *= 1 - lr wd``, then
    ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, params: dict, opt: dict):
        self.params = params
        self.beta2 = float(opt.get("betas", (0.9, 0.999))[1])
        self.eps = float(opt.get("eps", 1e-8))
        self.wd = float(opt.get("weight_decay", 0.01))
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float, beta1: float) -> None:
        self.t += 1
        bc1 = 1.0 - beta1 ** self.t
        bc2_sqrt = math.sqrt(1.0 - self.beta2 ** self.t)
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1.0 - lr * self.wd)
            self.m[n].lerp_(g, 1.0 - beta1)
            self.v[n].mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            denom = (self.v[n].sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
