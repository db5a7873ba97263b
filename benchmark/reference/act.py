"""The reference ACTPCD (ACT over PointNet point-cloud tokens) in plain
PyTorch: the training loss of one batch, and the actions of a request.

The model, as the configuration describes it: PointNet features of every
valid point; FPS to ``pcd_npoints`` token centres and kNN groups of
``pcd_nsample``, pooled into tokens by a linear, a batch norm over every
(token, neighbour) slot, a ReLU and a max; sine positions of the centres;
a CVAE posterior (a post-norm transformer encoder over [CLS, qpos, actions],
its key padding masked) whose sample becomes the latent token; a post-norm
encoder over [latent, qpos, goal, tokens]; the first of the decoder's layers
over zero targets at learned query positions, then the decoder's norm; a
linear action head; loss = masked mean squared error + kl_weight * KL.

Dropout (``train``): the attention weights of the short rows (the posterior
and the decoder) and every residual branch draw from the ``"dropout"``
stream, the posterior's noise from ``"vae"``, and the encoder's long rows a
Philox mask whose seed is drawn from the CPU stream ``"seed"``. The
streams are the generators :func:`streams` makes, seeded as the trainer
seeds its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import plain

__all__ = ["streams", "loss", "predict"]

LONG_ROWS = 512  # key rows from which the encoder takes its long attention


def streams(seed: int, device) -> dict:
    """The step's random streams: "vae" and "dropout" on the device, "seed"
    on the CPU, seeded ``seed * 3 + i`` in that order."""
    return {"vae": torch.Generator(device=device).manual_seed(seed * 3),
            "dropout": torch.Generator(device=device).manual_seed(seed * 3 + 1),
            "seed": torch.Generator().manual_seed(seed * 3 + 2)}


def _core(mask, rate, rngs, dense=False):
    """The attention core of a layer: dense for the decoder, for masked and
    for short rows, the long-row attention otherwise; dropout only with
    ``rngs``."""
    def core(q, k, v):
        if dense or mask is not None or k.shape[1] < LONG_ROWS:
            return plain.dense_attention(q, k, v, mask, rate,
                                         rngs["dropout"] if rngs else None)
        if not rngs:
            return plain.long_attention(q, k, v)
        seed = int(torch.randint(0, 2 ** 32, (), generator=rngs["seed"]))
        return plain.long_attention(q, k, v, rate, seed)
    return core


def _encoder_layer(P, name, src, pos, mask, cfg, rngs):
    rate = cfg["dropout"]
    drop = lambda x: plain.bits_dropout(x, rate, rngs["dropout"] if rngs else None)  # noqa: E731
    qk = src + pos.to(src.dtype)
    src = src + drop(plain.mha(P, name + ".self_attn", qk, qk, src, cfg["nheads"],
                               _core(mask, rate, rngs)))
    src = plain.layer_norm(src, P, name + ".norm1")
    h = plain.linear(drop(F.relu(plain.linear(src, P, name + ".linear1"))), P, name + ".linear2")
    return plain.layer_norm(src + drop(h), P, name + ".norm2")


def _decoder_layer(P, name, tgt, memory, pos, query_pos, cfg, rngs):
    rate = cfg["dropout"]
    drop = lambda x: plain.bits_dropout(x, rate, rngs["dropout"] if rngs else None)  # noqa: E731
    qk = tgt + query_pos
    tgt = plain.layer_norm(tgt + drop(plain.mha(P, name + ".self_attn", qk, qk, tgt,
                                                cfg["nheads"], _core(None, rate, rngs, dense=True))),
                           P, name + ".norm1")
    tgt = tgt + drop(plain.mha(P, name + ".multihead_attn", tgt + query_pos,
                               memory + pos.to(memory.dtype), memory, cfg["nheads"],
                               _core(None, rate, rngs, dense=True)))
    tgt = plain.layer_norm(tgt, P, name + ".norm2")
    h = plain.linear(drop(F.relu(plain.linear(tgt, P, name + ".linear1"))), P, name + ".linear2")
    return plain.layer_norm(tgt + drop(h), P, name + ".norm3")


def _actions(P, batch, cfg, train, rngs, B=None):
    """(a_hat, mu, logvar): the decoder's action chunk and the posterior's
    moments (None without actions)."""
    qpos, goal, pcds = batch["qpos"], batch["goal_cond"], batch["pcds"]
    n, D, dt = qpos.shape[0], cfg["hidden_dim"], qpos.dtype
    mu = logvar = None
    if "actions" in batch:
        actions, is_pad = batch["actions"], batch["is_pad"].to(torch.bool)
        tokens = torch.cat([P["cls_embed"][None].expand(n, 1, D),
                            plain.linear(qpos, P, "encoder_joint_proj")[:, None],
                            plain.linear(actions, P, "encoder_action_proj")], dim=1)
        pad = torch.cat([is_pad.new_zeros((n, 2)), is_pad], dim=1)
        mask = ~pad[:, None, None, :]
        pos = plain.sinusoid_table(tokens.shape[1], D, qpos.device)
        x = tokens
        for i in range(cfg["enc_layers"]):
            x = _encoder_layer(P, f"encoder.layers.{i}", x, pos, mask, cfg,
                               rngs if train else None)
        info = plain.linear(x[:, 0], P, "latent_proj")
        mu, logvar = info[:, :cfg["latent_dim"]], info[:, cfg["latent_dim"]:]
        latent = mu
        if train:
            std = torch.exp(0.5 * logvar)
            latent = mu + std * torch.randn(std.shape, generator=rngs["vae"], device=std.device,
                                            dtype=std.dtype)
    else:
        latent = qpos.new_zeros((n, cfg["latent_dim"]))
    latent_input = plain.linear(latent, P, "latent_out_proj")

    valid = pcds["valid"].to(torch.bool)
    feats = plain.pointnet(P, "backbone", pcds["feat"], valid, train, B)
    centres, tok = plain.group_tokens(P, "pcd_linear", "pcd_bn", pcds["coord"], feats, valid,
                                      cfg["pcd_npoints"], cfg["pcd_nsample"], train, B)
    proprio = [plain.linear(qpos, P, "input_proj_robot_state")[:, None]]
    if cfg.get("goal_cond_dim", 0) > 0:
        proprio.append(plain.linear(goal.reshape(n, -1), P, "proj_goal_cond_emb")[:, None])
    src = torch.cat([latent_input[:, None]] + proprio + [tok], dim=1)
    add_pos = P["additional_pos_embed"].to(torch.float32)[None].expand(n, -1, -1)
    pos = torch.cat([add_pos, plain.coord_embedding_sine(centres, D)], dim=1)
    memory = src
    for i in range(cfg["enc_layers"]):
        memory = _encoder_layer(P, f"transformer.encoder.layers.{i}", memory, pos, None, cfg,
                                rngs if train else None)
    query_pos = P["query_embed"][None].expand(n, -1, -1)
    hs = _decoder_layer(P, "transformer.decoder.layers.0", torch.zeros_like(query_pos), memory,
                        pos, query_pos, cfg, rngs if train else None)
    hs = plain.layer_norm(hs, P, "transformer.decoder.norm")
    return plain.linear(hs, P, "action_head").to(dt), mu, logvar


def loss(P: dict, batch: dict, cfg: dict, rngs: dict) -> torch.Tensor:
    """The training loss of one batch (train mode: batch statistics, dropout,
    the posterior sampled), in the parameters' type."""
    a_hat, mu, logvar = _actions(P, batch, cfg, True, rngs)
    keep = (~batch["is_pad"].to(torch.bool))[..., None].to(a_hat.dtype)
    diff = a_hat - batch["actions"]
    action_loss = (diff * diff * keep).mean()
    kl = (-0.5 * (1 + logvar - mu * mu - torch.exp(logvar))).sum(dim=-1).mean()
    return action_loss + kl * cfg["kl_weight"]


@torch.no_grad()
def predict(P: dict, B: dict, obs: dict, cfg: dict) -> torch.Tensor:
    """Actions (n, num_queries, action_dim) of a request (no actions):
    running statistics, no dropout, a zero latent."""
    return _actions(P, obs, cfg, False, None, B)[0]
