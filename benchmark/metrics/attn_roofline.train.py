"""The encoder's self-attention, forward and backward, at the cell's shapes
(batch, heads, the encoder's rows, head width; the configuration's dropout
rate) in the step's type, through the attention core of the model's own
first encoder layer, timed with CUDA events: its least time from shapes
(``flops.attention_bound_s``) over that time, %. None where the model has no
such encoder."""

import torch

from benchmark import flops
from benchmark.timing import cuda_seconds


def read(ctx):
    if ctx.mode != "train" or torch.device(ctx.device).type != "cuda":
        return None
    layers = getattr(getattr(getattr(ctx.module.policy, "transformer", None), "encoder", None),
                     "layers", None)
    if not layers:
        return None
    attn, cfg = layers[0].self_attn, ctx.cfg
    B, H = ctx.traffic["batch_size"], attn.nhead
    dh = cfg["hidden_dim"] // H
    L = cfg["pcd_npoints"] + 2 + (1 if cfg.get("goal_cond_dim", 0) > 0 else 0)
    bf16 = ctx.traffic["precision"] == "bf16-mixed"
    dt = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    q, k, v, dout = (torch.randn((B, L, H, dh), generator=gen, device=ctx.device, dtype=dt)
                     for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    rngs = {"dropout": torch.Generator(device=ctx.device).manual_seed(1),
            "seed": torch.Generator().manual_seed(2)}

    def fwd_bwd():
        out = attn.attention_fn(q, k, v, mask=None, dropout_rate=attn.dropout_rate,
                                deterministic=False, rngs=rngs)
        torch.autograd.grad(out, (q, k, v), dout)

    seconds = cuda_seconds(fwd_bwd, reps=10)
    return 100.0 * flops.attention_bound_s(B, H, L, dh, "bf16" if bf16 else "f32_product") / seconds
