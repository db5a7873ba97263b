"""FPS and kNN over the clouds of one of the cell's batches (as the step
casts them), through the port's op API, timed with CUDA events: the sum of
their least times from the valid points (``flops.fps_bound_s``,
``flops.knn_bound_s``) over the sum of their times, %."""

import torch

from benchmark import flops
from benchmark.timing import cuda_seconds


def read(ctx):
    if ctx.mode != "train" or torch.device(ctx.device).type != "cuda":
        return None
    from pointcloudmatters_tpu_torch.ops.pointops import (
        farthest_point_sampling_padded,
        knn_query_padded,
    )

    pcds = ctx.adapter.clouds(ctx.sample)
    dt = torch.bfloat16 if ctx.traffic["precision"] == "bf16-mixed" else torch.float32
    coord = pcds["coord"].to(dt).to(torch.float32).contiguous()
    valid = pcds["valid"].to(torch.bool).contiguous()
    M, K = ctx.cfg["pcd_npoints"], ctx.cfg["pcd_nsample"]
    t_fps = cuda_seconds(lambda: farthest_point_sampling_padded(coord, valid, M), reps=5)
    idx = farthest_point_sampling_padded(coord, valid, M).long()
    centres = torch.gather(coord, 1, idx[..., None].expand(-1, -1, 3)).contiguous()
    t_knn = cuda_seconds(lambda: knn_query_padded(centres, coord, valid, K), reps=5)
    C, N = coord.shape[:2]
    n_valid = int(valid.sum())
    least = (flops.fps_bound_s(n_valid, C * N, C, M)
             + flops.knn_bound_s(n_valid, C * N, C, M, K))
    return 100.0 * least / (t_fps + t_knn)
