"""The reference Diffusion Policy over point clouds in plain PyTorch: the
training loss of one batch, and the whole reverse chain of a request.

The model, as the configuration describes it: each observation frame's
cloud through PointNet (with its final linear), the token grouping (FPS,
kNN, linear, batch norm over every slot, ReLU, max), a pointwise projector
(linear, batch norm, ReLU), a max over the tokens and an output linear with
its batch norm; the frames' features beside the normalised qpos, then the
goal, form the global condition of a 1-D temporal UNet with FiLM (scale and
bias) residual blocks, group norms and Mish; DDPM (``squaredcos_cap_v2``)
with epsilon prediction. Every UNet layer computes in the promoted type of
its input and its weights, so that an f32 trajectory meets bf16-rounded
weights in f32 under mixed precision.

The normaliser is worked out from the raw data the benchmark generated:
each field to [-1, 1] by its minimum and maximum. The loss's noise and
timesteps come from the ``"noise"`` stream, the chain's from the request's
generator, both as the program draws them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain

__all__ = ["streams", "normalizer", "alphas_cumprod", "loss", "predict"]


def streams(seed: int, device) -> dict:
    """The step's "noise" stream, seeded as the trainer seeds it."""
    return {"noise": torch.Generator(device=device).manual_seed(seed * 4)}


def normalizer(data: dict, range_eps: float = 1e-4) -> dict:
    """{field: (scale, offset)} as f32 numpy: [min, max] -> [-1, 1]; a
    field of range under ``range_eps`` maps to the centre."""
    out = {}
    for key, arr in data.items():
        arr = np.asarray(arr, np.float32).reshape(-1, np.asarray(arr).shape[-1])
        lo, hi = arr.min(0), arr.max(0)
        rng = hi - lo
        ignore = rng < range_eps
        rng = np.where(ignore, 2.0, rng)
        scale = (2.0 / rng).astype(np.float32)
        offset = np.where(ignore, -lo, -1.0 - scale * lo).astype(np.float32)
        out[key] = (scale, offset)
    return out


def alphas_cumprod(cfg: dict) -> np.ndarray:
    """The squaredcos_cap_v2 betas in f64, their cumulative product, f32."""
    n = cfg["num_train_timesteps"]

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999)
                      for i in range(n)], np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32)


def _norm(x, scale_offset):
    scale, offset = (torch.from_numpy(a).to(x.device) for a in scale_offset)
    return x * scale + offset


# --------------------------------------------------------------------------
# the UNet
# --------------------------------------------------------------------------
def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _promoted(x, P, name):
    w = P[name + ".weight"]
    dt = torch.promote_types(x.dtype, w.dtype)
    b = P.get(name + ".bias")
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def _conv(x, P, name, stride=1, padding=0):
    x, w, b = _promoted(x, P, name)
    return F.conv1d(x, w, b, stride, padding)


def _linear(x, P, name):
    x, w, b = _promoted(x, P, name)
    return F.linear(x, w, b)


def _block(x, P, name, k, groups):
    x = _conv(x, P, name + ".conv", padding=k // 2)
    x, w, b = _promoted(x, P, name + ".norm")
    return _mish(F.group_norm(x, groups, w, b, 1e-5))


def _res(x, cond, P, name, k, groups):
    out = _block(x, P, name + ".block0", k, groups)
    c = out.shape[1]
    embed = _linear(_mish(cond), P, name + ".cond_encoder")[:, :, None]
    out = embed[:, :c] * out + embed[:, c:]
    out = _block(out, P, name + ".block1", k, groups)
    if name + ".residual_conv.weight" in P:
        x = _conv(x, P, name + ".residual_conv")
    return out + x


def unet(P, sample, timesteps, global_cond, cfg):
    """(B, T, action_dim) trajectory, (B,) timesteps, (B, G) condition ->
    (B, T, action_dim)."""
    k, groups, dsed = cfg["kernel_size"], cfg["n_groups"], cfg["diffusion_step_embed_dim"]
    half = dsed // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=sample.device)
                     * (-math.log(10000.0) / (half - 1)))
    ang = timesteps.to(torch.float32)[:, None] * freq[None, :]
    t = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(sample.dtype)
    t = _linear(_mish(_linear(t, P, "model.time_mlp1")), P, "model.time_mlp2")
    cond = torch.cat([t, global_cond], dim=-1)
    levels = len(cfg["down_dims"])
    x = sample.transpose(1, 2)
    skips = []
    for i in range(levels):
        x = _res(x, cond, P, f"model.down{i}_res0", k, groups)
        x = _res(x, cond, P, f"model.down{i}_res1", k, groups)
        skips.append(x)
        if i < levels - 1:
            x = _conv(x, P, f"model.down{i}_ds.conv", stride=2, padding=1)
    x = _res(x, cond, P, "model.mid_res0", k, groups)
    x = _res(x, cond, P, "model.mid_res1", k, groups)
    for i in range(levels - 1):
        x = torch.cat([x, skips.pop()], dim=1)
        x = _res(x, cond, P, f"model.up{i}_res0", k, groups)
        x = _res(x, cond, P, f"model.up{i}_res1", k, groups)
        x, w, b = _promoted(x, P, f"model.up{i}_us.conv")
        x = F.conv_transpose1d(x, w, b, 2, 1)
    x = _block(x, P, "model.final_block", k, groups)
    return _conv(x, P, "model.final_conv").transpose(1, 2)


# --------------------------------------------------------------------------
# the observation encoder and the condition
# --------------------------------------------------------------------------
def _encode(P, pcds, cfg, train, B=None):
    valid = pcds["valid"].to(torch.bool)
    feats = plain.pointnet(P, "obs_encoder.pcd_model", pcds["feat"], valid, train, B)
    _, x = plain.group_tokens(P, "obs_encoder.linear", "obs_encoder.bn", pcds["coord"], feats,
                              valid, cfg["pcd_npoints"], cfg["pcd_nsample"], train, B)
    for i in range(cfg["projector_layers"]):
        x = plain.linear(x, P, f"obs_encoder.projector_conv{i}")
        x = F.relu(plain.batch_norm(x, P, f"obs_encoder.projector_bn{i}", 1e-5, train, None, B))
    x = plain.linear(x.amax(dim=1), P, "obs_encoder.projector_out")
    return plain.batch_norm(x, P, "obs_encoder.projector_out_bn", 1e-5, train, None, B)


def _global_cond(P, batch, cfg, norm, train, B=None):
    obs = batch["obs"]
    qpos = _norm(obs["qpos"], norm["qpos"])
    n, To = qpos.shape[0], cfg["n_obs_steps"]
    feats = _encode(P, obs["pcds"], cfg, train, B)
    frames = torch.cat([feats, qpos[:, :To].reshape(n * To, -1)], dim=-1).reshape(n, -1)
    return torch.cat([frames, batch["goal"]["task_emb"].reshape(n, -1)], dim=-1)


def loss(P: dict, batch: dict, cfg: dict, rngs: dict, norm: dict,
         abar: np.ndarray) -> torch.Tensor:
    """The epsilon-prediction loss of one batch at timesteps and noise from
    ``rngs["noise"]`` (train mode: batch statistics)."""
    cond = _global_cond(P, batch, cfg, norm, True)
    traj = _norm(batch["action"], norm["action"])
    gen = rngs["noise"]
    noise = torch.randn(traj.shape, generator=gen, device=gen.device, dtype=traj.dtype)
    steps = torch.randint(0, cfg["num_train_timesteps"], (traj.shape[0],), generator=gen,
                          device=gen.device, dtype=torch.int32)
    a = torch.from_numpy(abar).to(traj.device)[steps.long()][:, None, None]
    noisy = (torch.sqrt(a) * traj.to(torch.float32)
             + torch.sqrt(1.0 - a) * noise.to(torch.float32)).to(traj.dtype)
    pred = unet(P, noisy, steps, cond, cfg)
    return ((pred - noise) ** 2).reshape(traj.shape[0], -1).mean(dim=-1).mean()


def _step(abar, model_output, t, t_prev, sample, noise):
    """x_t -> x_{t-1}: DDPM's posterior mean from the clipped x0 estimate,
    plus sqrt(variance) noise but at t = 0; f32."""
    abar_t = torch.tensor(abar[t], dtype=torch.float32)
    abar_prev = torch.tensor(abar[t_prev] if t_prev >= 0 else 1.0, dtype=torch.float32)
    beta_t = 1.0 - abar_t / abar_prev
    alpha_t = 1.0 - beta_t
    x0 = (sample - torch.sqrt(1.0 - abar_t) * model_output) / torch.sqrt(abar_t)
    x0 = torch.clamp(x0, -1.0, 1.0)
    mean = (torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t) * x0
            + torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t) * sample)
    variance = torch.clamp(beta_t * (1.0 - abar_prev) / (1.0 - abar_t), min=1e-20)
    add = torch.sqrt(variance) if t > 0 else torch.zeros((), dtype=torch.float32)
    return mean + add * noise


@torch.no_grad()
def predict(P: dict, B: dict, obs: dict, cfg: dict, norm: dict, abar: np.ndarray,
            gen: torch.Generator) -> torch.Tensor:
    """The executed actions (n, n_action_steps, action_dim) of the whole
    reverse chain, every draw from ``gen`` (running statistics)."""
    cond = _global_cond(P, obs, cfg, norm, False, B)
    n = cond.shape[0]
    shape = (n, cfg["horizon"], cfg["action_dim"])
    steps = cfg["num_inference_steps"]
    ratio = cfg["num_train_timesteps"] // steps
    ts = (np.arange(0, steps) * ratio).round()[::-1].astype(np.int64).tolist()
    traj = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        pred = unet(P, traj, torch.full((n,), t, dtype=torch.int32, device=traj.device), cond,
                    cfg)
        noise = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        traj = _step(abar, pred.to(torch.float32), t, t_prev, traj, noise)
    scale, offset = (torch.from_numpy(a).to(traj.device) for a in norm["action"])
    start = cfg["n_obs_steps"] - 1
    return ((traj - offset) / scale)[:, start:start + cfg["n_action_steps"]]
