"""The yardstick's arithmetic: the card's peaks, roofline bounds, and the
operations and bytes of each measured piece, counted from shapes.

Peaks are one H100 SXM's published dense rates at 700 W. Products (matrix
multiplications and convolutions) in f32 are held against 165 TFLOP/s, the
TF32 tensor cores' 495 divided by the three products of 3xTF32, which the
port uses for exact f32 attention: against the FMA pipes' 67 TFLOP/s a sound
3xTF32 kernel would read above 100%. Other f32 work (FPS and kNN distances)
is held against 67. bf16 products against 989.

A share of a peak is the least time the work could take (each part's
operations over the peak of its type, or its bytes over the memory rate,
the larger) over the time it took. Model operations count matrix products
only (2 per multiply-add), forward once and backward twice, nothing
recomputed; point-wise work (norms, activations, softmax) is not counted.
Per-point layers count the valid points only: padding is no work a user
asks for.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK", "bound_s", "fps_bound_s", "knn_bound_s",
           "attention_bound_s", "pointnet_macs", "act_flops", "dp_encoder_macs",
           "unet_macs", "dp_step_flops", "dp_request_flops", "unet_call_bytes",
           "least_seconds"]

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "f32_product": 165e12, "f32": 67e12}

# PointNet's per-point linears: (in, out), bias-free (the final linear is not
# here: its width is the model's)
POINTNET_WIDTHS = (64, 64, 64, 128, 512)


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The least seconds: the larger of the bytes over the memory rate and
    the operations over the peak of ``kind``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK[kind])


def least_seconds(parts: dict) -> float:
    """Seconds at peak of ``{kind: flops}``, the kinds summed."""
    return sum(flops / PEAK[kind] for kind, flops in parts.items())


def fps_bound_s(n_valid: int, n_slots: int, clouds: int, npoints: int) -> float:
    """FPS: npoints - 1 rounds of ~8 operations a valid point (the padding
    needs none); xyz (f32) and the mask read, the indices written."""
    return bound_s(8.0 * n_valid * (npoints - 1),
                   n_slots * 12 + n_slots + clouds * npoints * 4, "f32")


def knn_bound_s(n_valid: int, n_slots: int, clouds: int, queries: int, k: int) -> float:
    """kNN: ~8 operations a (query, valid point) distance; queries and
    points read, indices and squared distances written."""
    return bound_s(8.0 * queries * n_valid,
                   (clouds * queries + n_slots) * 12 + n_slots + clouds * queries * k * 8,
                   "f32")


def attention_bound_s(B: int, H: int, L: int, dh: int, kind: str) -> float:
    """Self-attention forward and backward: 4 B H L^2 dh operations forward
    (two products), 8 backward (dV, dP, dQ, dK; the scores not recomputed);
    q, k, v read and o written forward, q, k, v, o, dO read and dq, dk, dv
    written backward."""
    elem = 2 if kind == "bf16" else 4
    t = B * H * L * dh * elem
    return bound_s(12.0 * B * H * L * L * dh, 12 * t, kind)


def pointnet_macs(in_channels: int, num_classes: int = 0) -> int:
    """Multiply-adds of PointNet for one point."""
    macs, c = 0, in_channels
    for w in POINTNET_WIDTHS:
        macs += c * w
        c = w
    return macs + (c * num_classes if num_classes > 0 else 0)


def _encoder_layer_macs(L: int, D: int, ffn: int) -> int:
    """One post-norm self-attention layer over L tokens: q, k, v, out
    projections, the two attention products, the feed-forward pair."""
    return 4 * L * D * D + 2 * L * L * D + 2 * L * D * ffn


def act_flops(cfg: dict, batch: int, n_valid: int, dtype: str, train: bool = True) -> dict:
    """``{peak kind: operations}`` of ACTPCD over ``batch`` samples whose
    clouds hold ``n_valid`` valid points in all: a training step (the CVAE
    posterior included, forward and backward) or, with ``train`` False, a
    forward without actions (no posterior)."""
    D, ffn, nq = cfg["hidden_dim"], cfg["dim_feedforward"], cfg["num_queries"]
    M = cfg["pcd_npoints"]
    n_extra = 2 + (1 if cfg.get("goal_cond_dim", 0) > 0 else 0)
    L = M + n_extra
    feat_c = POINTNET_WIDTHS[-1]
    posterior = (cfg["enc_layers"] * _encoder_layer_macs(2 + nq, D, ffn)
                 + nq * cfg["action_dim"] * D + cfg["qpos_dim"] * D
                 + D * 2 * cfg["latent_dim"])
    per_sample = (
        (posterior if train else 0) + cfg["latent_dim"] * D
        # the token grouping's query rows and the proprio tokens
        + M * (3 + feat_c) * D + (cfg["qpos_dim"] + cfg.get("goal_cond_dim", 0)) * D
        # the encoder
        + cfg["enc_layers"] * _encoder_layer_macs(L, D, ffn)
        # the one live decoder layer: self-attention over the queries, cross
        # attention into the memory, the feed-forward pair, the heads
        + _encoder_layer_macs(nq, D, ffn) + 2 * nq * D * D + 2 * L * D * D
        + 2 * nq * L * D + nq * D * (cfg["action_dim"] + 1))
    per_point = pointnet_macs(cfg["in_channels"]) + (3 + feat_c) * D
    fwd = 2.0 * (batch * per_sample + n_valid * per_point)
    kind = "bf16" if dtype == "bf16" else "f32_product"
    return {kind: (3.0 if train else 1.0) * fwd}


def dp_encoder_macs(cfg: dict, clouds: int, n_valid: int) -> int:
    """The point-cloud observation encoder over ``clouds`` clouds holding
    ``n_valid`` valid points: PointNet and the token grouping's source rows
    a valid point, its query rows, projector and output a token."""
    C, M, hidden = cfg["pcd_feature_dim"], cfg["pcd_npoints"], cfg["pcd_hidden_dim"]
    widths = [hidden] + list(cfg["projector_channels"])
    layers = cfg["projector_layers"]
    proj = sum(widths[i] * widths[i + 1] for i in range(layers))
    per_point = pointnet_macs(cfg["in_channels"], C) + (3 + C) * hidden
    # the token grouping's query rows and the projector a token, its output a cloud
    per_cloud = M * (3 + C) * hidden + M * proj + widths[layers] * widths[layers + 1]
    return n_valid * per_point + clouds * per_cloud


def _res_block_macs(c_in: int, c_out: int, T: int, k: int, cond: int, scale: bool) -> int:
    return (T * c_in * c_out * k + T * c_out * c_out * k + cond * c_out * (2 if scale else 1)
            + (T * c_in * c_out if c_in != c_out else 0))


def unet_macs(cfg: dict, batch: int) -> int:
    """ConditionalUnet1D over a (batch, horizon, action_dim) trajectory, as
    the port runs it: every down level two residual blocks and, but the
    last, a stride-2 convolution; two middle blocks; every up level but the
    first's skip two blocks and a 2x transposed convolution; the final
    block and 1x1 convolution."""
    dims = [cfg["action_dim"]] + list(cfg["down_dims"])
    k, dsed, T = cfg["kernel_size"], cfg["diffusion_step_embed_dim"], cfg["horizon"]
    cond = dsed + unet_cond_dim(cfg)
    scale = cfg.get("cond_predict_scale", True)
    macs = dsed * 4 * dsed * 2  # the step embedding's two linears
    levels = len(dims) - 1
    for i in range(levels):
        macs += _res_block_macs(dims[i], dims[i + 1], T, k, cond, scale)
        macs += _res_block_macs(dims[i + 1], dims[i + 1], T, k, cond, scale)
        if i < levels - 1:
            T //= 2
            macs += T * dims[i + 1] * dims[i + 1] * 3
    macs += 2 * _res_block_macs(dims[-1], dims[-1], T, k, cond, scale)
    for i in range(levels - 1):
        c_out, c_in = dims[levels - 1 - i], dims[levels - i]
        macs += _res_block_macs(2 * c_in, c_out, T, k, cond, scale)
        macs += _res_block_macs(c_out, c_out, T, k, cond, scale)
        macs += T * c_out * c_out * 4
        T *= 2
    macs += T * dims[1] * dims[1] * k + T * dims[1] * dims[0]
    return batch * macs


def unet_cond_dim(cfg: dict) -> int:
    """Width of the global condition: each observation frame's cloud
    features and low-dimensional keys, and the goal's."""
    frame = list(cfg["projector_channels"])[cfg["projector_layers"]] + cfg["qpos_dim"]
    return frame * cfg["n_obs_steps"] + cfg.get("goal_dim", 0)


def dp_step_flops(cfg: dict, batch: int, n_valid: int) -> dict:
    """``{peak kind: operations}`` of one DP training step under bf16-mixed:
    the encoder's products in bf16, the UNet's in f32 (the normalizer's f32
    constants promote its inputs)."""
    enc = dp_encoder_macs(cfg, batch * cfg["n_obs_steps"], n_valid)
    return {"bf16": 6.0 * enc, "f32_product": 6.0 * unet_macs(cfg, batch)}


def dp_request_flops(cfg: dict, batch: int, n_valid: int) -> dict:
    """``{peak kind: operations}`` of one f32 ``predict``: the encoder once,
    the UNet ``num_inference_steps`` times."""
    return {"f32_product": 2.0 * (dp_encoder_macs(cfg, batch * cfg["n_obs_steps"], n_valid)
                                  + cfg["num_inference_steps"] * unet_macs(cfg, batch))}


def unet_call_bytes(n_params: int, cfg: dict, batch: int, elem: int = 4) -> int:
    """One UNet call's least bytes: every weight read once, the trajectory
    and the condition read and the prediction written."""
    traj = batch * cfg["horizon"] * cfg["action_dim"]
    return elem * (n_params + 2 * traj + batch * unet_cond_dim(cfg))
