"""The Diffusion Policy over point clouds (``configs/model/
maniskill2_diffusion_policy_model.yaml`` with the PickCube-v0 point-cloud
task): the program's policy and task module built from the configuration
file, its batches and requests in the collate layout, the dataset's
normaliser fitted on raw data drawn from the seed, and the plain reference
beside it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops
from benchmark import traffic as T
from benchmark.reference import dp as ref

__all__ = ["make_policy", "make_module", "make_pool", "make_requests", "clouds", "step_flops",
           "request_flops", "predict", "ref_streams", "ref_loss", "ref_predict", "ref_extras"]


def make_policy(cfg: dict, device) -> torch.nn.Module:
    """The port's DiffusionUnetImagePolicy over ``PCDObsEncoder`` at the
    configuration's widths, built on ``device`` (its weights to be drawn by
    the harness, its normaliser set by :func:`make_module`)."""
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.ddpm import (
        DDPMScheduler,
    )
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion_unet_image_policy import (  # noqa: E501
        DiffusionUnetImagePolicy,
    )
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.pcd_obs_encoder import (  # noqa: E501
        PCDObsEncoder,
    )
    from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import PointNet

    with torch.device(device):
        encoder = PCDObsEncoder(
            shape_meta=cfg["shape_meta"],
            pcd_model=PointNet(in_channels=cfg["in_channels"], num_classes=cfg["pcd_feature_dim"]),
            n_obs_step=cfg["n_obs_steps"], pcd_nsample=cfg["pcd_nsample"],
            pcd_npoints=cfg["pcd_npoints"], pcd_hidden_dim=cfg["pcd_hidden_dim"],
            projector_layers=cfg["projector_layers"],
            projector_channels=list(cfg["projector_channels"]), pre_sample=False)
        policy = DiffusionUnetImagePolicy(
            shape_meta=cfg["shape_meta"],
            noise_scheduler=DDPMScheduler(
                num_train_timesteps=cfg["num_train_timesteps"], beta_start=cfg["beta_start"],
                beta_end=cfg["beta_end"], beta_schedule=cfg["beta_schedule"],
                clip_sample=True, prediction_type="epsilon"),
            obs_encoder=encoder, horizon=cfg["horizon"], n_action_steps=cfg["n_action_steps"],
            n_obs_steps=cfg["n_obs_steps"], num_inference_steps=cfg["num_inference_steps"],
            diffusion_step_embed_dim=cfg["diffusion_step_embed_dim"],
            down_dims=tuple(cfg["down_dims"]), kernel_size=cfg["kernel_size"],
            n_groups=cfg["n_groups"], cond_predict_scale=cfg["cond_predict_scale"])
    return policy.to(device)


def make_module(policy, cfg: dict, data: dict):
    """The task module, its policy's normaliser fitted by the port on the
    raw ``data`` (the "dataset")."""
    from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
        ManiSkill2DiffusionPolicyBCModule,
    )
    from pointcloudmatters_tpu_torch.utils.normalizer import LinearNormalizer

    normalizer = LinearNormalizer()
    normalizer.fit(data)
    policy.normalizer = normalizer
    return ManiSkill2DiffusionPolicyBCModule(
        policy, optimizer=dict(cfg["optimizer"]),
        lr_scheduler={"scheduler": dict(cfg["lr_scheduler"])}, env_id=cfg["env_id"])


def _dataset(cfg, tr, gen) -> dict:
    """Raw actions and qpos from which the normaliser is fitted, numpy."""
    rows = tr["normalizer_rows"]
    return {"action": T.normal(gen, rows, cfg["action_dim"]).cpu().numpy(),
            "qpos": T.normal(gen, rows, cfg["qpos_dim"]).cpu().numpy()}


def _batch(cfg, tr, gen, pcds, with_actions):
    n, To = pcds["valid"].shape[0] // cfg["n_obs_steps"], cfg["n_obs_steps"]
    out = {"obs": {"qpos": T.normal(gen, n, To, cfg["qpos_dim"]), "pcds": pcds},
           "goal": {"task_emb": T.normal(gen, n, cfg["goal_dim"])}}
    if with_actions:
        out["action"] = T.normal(gen, n, cfg["horizon"], cfg["action_dim"])
    return out


def _batches(cfg, tr, gen, with_actions):
    """``pool`` batches of ``batch_size`` scene states each, in catalog order:
    both frames of each state (the two observation steps) through the
    dataset's path."""
    if cfg["n_obs_steps"] != 2:
        raise ValueError("the scene renders two frames a state")
    scene, frames = T.scene_frames(tr, gen.device)
    B = tr["batch_size"]
    index = torch.arange(tr["pool"] * B, device=gen.device).view(tr["pool"], B)
    return [_batch(cfg, tr, gen, T.clouds(scene, frames, ix, gen, both=True), with_actions)
            for ix in index]


def make_pool(cfg: dict, tr: dict, gen: torch.Generator) -> tuple[list, dict]:
    """``pool`` distinct training batches on the device (B * To clouds each,
    sample by sample), the first of each shape first, and the raw dataset the
    normaliser comes from."""
    data = _dataset(cfg, tr, gen)
    pool = _batches(cfg, tr, gen, True)
    return T.shapes_first(pool, lambda b: b["obs"]["pcds"]["valid"].shape[1]), data


def make_requests(cfg: dict, tr: dict, gen: torch.Generator) -> tuple[list, dict]:
    """``pool`` requests (no actions) as numpy dicts, as a client sends
    them, and the raw dataset the normaliser comes from."""
    data = _dataset(cfg, tr, gen)
    return [T.to_numpy(b) for b in _batches(cfg, tr, gen, False)], data


def clouds(batch: dict) -> dict:
    return batch["obs"]["pcds"]


def step_flops(cfg: dict, tr: dict, batches: list) -> dict:
    n_valid = float(np.mean([int(clouds(b)["valid"].sum()) for b in batches]))
    return flops.dp_step_flops(cfg, tr["batch_size"], n_valid)


def request_flops(cfg: dict, tr: dict, requests: list) -> dict:
    n_valid = float(np.mean([clouds(r)["valid"].sum() for r in requests]))
    return flops.dp_request_flops(cfg, tr["batch_size"], n_valid)


def predict(module, obs: dict, gen: torch.Generator) -> np.ndarray:
    return module.predict(obs, gen).float().cpu().numpy()


def ref_extras(cfg: dict, data: dict) -> dict:
    return {"norm": ref.normalizer(data), "abar": ref.alphas_cumprod(cfg)}


def ref_streams(stream_seed: int, device) -> dict:
    return ref.streams(stream_seed, device)


def ref_loss(P: dict, batch: dict, cfg: dict, rngs: dict, extras: dict) -> torch.Tensor:
    return ref.loss(P, batch, cfg, rngs, extras["norm"], extras["abar"])


def ref_predict(P: dict, B: dict, obs: dict, cfg: dict, extras: dict,
                gen: torch.Generator) -> torch.Tensor:
    return ref.predict(P, B, obs, cfg, extras["norm"], extras["abar"], gen)
