"""ACTPCD over PointNet (``configs/model/maniskill2_act_pcd_model.yaml`` with
``scratch_pointnet_pcd``): the program's policy and task module built from
the configuration file, its batches in the collate layout, and the plain
reference beside it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops
from benchmark import traffic as T
from benchmark.reference import act as ref

__all__ = ["make_policy", "make_module", "make_pool", "make_requests", "clouds", "step_flops",
           "request_flops", "predict", "ref_streams", "ref_loss", "ref_predict", "ref_extras"]


def make_policy(cfg: dict, device) -> torch.nn.Module:
    """The port's ACTPCD at the configuration's widths, built on ``device``
    (its weights to be drawn by the harness)."""
    from pointcloudmatters_tpu_torch.models.components.act.act import ACTPCD
    from pointcloudmatters_tpu_torch.models.components.act.transformer import (
        Transformer,
        TransformerEncoder,
    )
    from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import PointNet

    D, H, ffn, rate = cfg["hidden_dim"], cfg["nheads"], cfg["dim_feedforward"], cfg["dropout"]
    with torch.device(device):
        transformer = Transformer(
            d_model=D, nhead=H, num_encoder_layers=cfg["enc_layers"],
            num_decoder_layers=cfg["dec_layers"], dim_feedforward=ffn, dropout=rate,
            normalize_before=False, return_intermediate_dec=True,
            attention_impl=cfg["attention_impl"])
        encoder = TransformerEncoder(d_model=D, nhead=H, dim_feedforward=ffn,
                                     num_layers=cfg["enc_layers"], dropout=rate)
        policy = ACTPCD(
            backbone=PointNet(in_channels=cfg["in_channels"]), transformer=transformer,
            encoder=encoder, hidden_dim=D, num_queries=cfg["num_queries"],
            action_dim=cfg["action_dim"], qpos_dim=cfg["qpos_dim"],
            goal_cond_dim=cfg["goal_cond_dim"], latent_dim=cfg["latent_dim"],
            kl_weight=cfg["kl_weight"], action_loss=cfg["action_loss"],
            pcd_nsample=cfg["pcd_nsample"], pcd_npoints=cfg["pcd_npoints"])
    return policy.to(device)


def make_module(policy, cfg: dict, data: dict):
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    return BCModule(policy, optimizer=dict(cfg["optimizer"]),
                    lr_scheduler={"scheduler": dict(cfg["lr_scheduler"])})


def _batch(cfg, tr, gen, pcds, with_actions):
    n, nq = pcds["valid"].shape[0], cfg["num_queries"]
    out = {"qpos": T.normal(gen, n, cfg["qpos_dim"]),
           "goal_cond": T.normal(gen, n, cfg["goal_cond_dim"]), "pcds": pcds}
    if with_actions:
        out["actions"] = T.normal(gen, n, nq, cfg["action_dim"])
        pad = torch.arange(nq, device=gen.device)[None] >= nq - tr["padded_actions"]
        out["is_pad"] = pad.expand(n, nq).contiguous()
    return out


def _batches(cfg, tr, gen, with_actions):
    """``pool`` batches of ``batch_size`` scene states each, in catalog order:
    frame 0 of each state through the dataset's path."""
    scene, frames = T.scene_frames(tr, gen.device)
    B = tr["batch_size"]
    index = torch.arange(tr["pool"] * B, device=gen.device).view(tr["pool"], B)
    return [_batch(cfg, tr, gen, T.clouds(scene, frames, ix, gen), with_actions)
            for ix in index]


def make_pool(cfg: dict, tr: dict, gen: torch.Generator) -> tuple[list, dict]:
    """``pool`` distinct training batches on the device, the first of each
    shape first, and the raw data the module and the reference derive from
    (none for ACT)."""
    pool = _batches(cfg, tr, gen, True)
    return T.shapes_first(pool, lambda b: b["pcds"]["valid"].shape[1]), {}


def make_requests(cfg: dict, tr: dict, gen: torch.Generator) -> tuple[list, dict]:
    """``pool`` requests (no actions) as numpy dicts, as a client sends them."""
    return [T.to_numpy(b) for b in _batches(cfg, tr, gen, False)], {}


def clouds(batch: dict) -> dict:
    return batch["pcds"]


def step_flops(cfg: dict, tr: dict, batches: list) -> dict:
    n_valid = float(np.mean([int(b["pcds"]["valid"].sum()) for b in batches]))
    dtype = "bf16" if tr["precision"] == "bf16-mixed" else "f32"
    return flops.act_flops(cfg, tr["batch_size"], n_valid, dtype)


def request_flops(cfg: dict, tr: dict, requests: list) -> dict:
    n_valid = float(np.mean([r["pcds"]["valid"].sum() for r in requests]))
    return flops.act_flops(cfg, tr["batch_size"], n_valid, "f32", train=False)


def predict(module, obs: dict, gen: torch.Generator) -> np.ndarray:
    return module.predict(obs).float().cpu().numpy()


def ref_extras(cfg: dict, data: dict) -> dict:
    return {}


def ref_streams(stream_seed: int, device) -> dict:
    return ref.streams(stream_seed, device)


def ref_loss(P: dict, batch: dict, cfg: dict, rngs: dict, extras: dict) -> torch.Tensor:
    return ref.loss(P, batch, cfg, rngs)


def ref_predict(P: dict, B: dict, obs: dict, cfg: dict, extras: dict,
                gen: torch.Generator) -> torch.Tensor:
    return ref.predict(P, B, obs, cfg)
