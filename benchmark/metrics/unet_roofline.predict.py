"""One call of the policy's UNet at the request's batch, in f32 as
``predict`` runs it, timed with CUDA events over many calls: its least time
(the larger of its products at 165 TFLOP/s and of every weight read once
plus its inputs and output at 3.35 TB/s, ``benchmark/flops.py``) over that
time, %. None where the policy has no UNet."""

import torch

from benchmark import flops
from benchmark.timing import cuda_seconds


def read(ctx):
    if ctx.mode != "predict" or torch.device(ctx.device).type != "cuda":
        return None
    unet = getattr(ctx.module.policy, "model", None)
    if unet is None or not hasattr(unet, "down_dims"):
        return None
    cfg, B = ctx.cfg, ctx.traffic["batch_size"]
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    traj = torch.randn((B, cfg["horizon"], cfg["action_dim"]), generator=gen, device=ctx.device)
    cond = torch.randn((B, flops.unet_cond_dim(cfg)), generator=gen, device=ctx.device)
    with torch.inference_mode():
        seconds = cuda_seconds(lambda: unet(traj, cfg["num_train_timesteps"] // 2,
                                            global_cond=cond), reps=20)
    n_params = sum(p.numel() for p in unet.parameters())
    least = flops.bound_s(2.0 * flops.unet_macs(cfg, B),
                          flops.unet_call_bytes(n_params, cfg, B), "f32_product")
    return 100.0 * least / seconds
