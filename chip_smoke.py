#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no result):

1. Needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Builds the hand-written CUDA kernels from ``pointcloudmatters_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time and ptxas's resource use.
3. Holds each kernel against its plain PyTorch version on the card at the
   flagship's shapes, and times both:
   FPS B=4, N=10240 -> 2048 (index-exact); kNN B=4, M=2048, N=10240, k=16
   (indices exact, d2 within 1e-6 relative); attention B=4, H=8, L=2051,
   dh=64, f32 (max abs error <= 1e-4; also dh=128 and a masked key tail).
4. Serves the flagship ACT + PointNet policy (24,124,456 parameters, seeded
   random weights) through ``BCModule.predict``: 3 requests at B=1 and 1 at
   B=32, N=10240, no actions. Checks a_hat's shape and finiteness, that each
   kernel was launched in that run, that the B=32 answer matches the same
   predict with every kernel swapped for its plain version (1e-3 abs), and
   that a small policy on the card matches itself on the CPU (1e-4).

Prints a JSON line of the kernels (route, source, the TPU kernel each
replaces, launches on the main path, error and times), then as its last line
``{"ok": true, "device": {...}}``. Times are CUDA-event or synchronised
host-clock milliseconds on the card named above.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 10240  # points a cloud
BIG_BATCH = 32    # the bench batch
KERNELS = {
    "fps": ("pointcloudmatters_tpu_torch/csrc/fps.cu",
            "pointcloudmatters_tpu/ops/pallas_fps.py:30"),
    "knn": ("pointcloudmatters_tpu_torch/csrc/knn.cu",
            "pointcloudmatters_tpu/ops/pallas_knn3.py:46"),
    "attention_fwd": ("pointcloudmatters_tpu_torch/csrc/attention_fwd.cu",
                      "pointcloudmatters_tpu/ops/oneshot_attention.py:68"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run, by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the path for its plain PyTorch version."""
    from pointcloudmatters_tpu_torch.ops import fps, knn, oneshot_attention
    from pointcloudmatters_tpu_torch.ops import pointops

    saved = (fps.farthest_point_sampling_padded_cuda, knn.knn_query_padded_cuda,
             oneshot_attention.oneshot_attention_cuda)
    fps.farthest_point_sampling_padded_cuda = pointops.farthest_point_sampling_padded_plain
    knn.knn_query_padded_cuda = pointops.knn_query_padded_plain
    oneshot_attention.oneshot_attention_cuda = oneshot_attention.oneshot_attention_plain
    try:
        yield
    finally:
        (fps.farthest_point_sampling_padded_cuda, knn.knn_query_padded_cuda,
         oneshot_attention.oneshot_attention_cuda) = saved


def check_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version; returns per-kernel
    max_abs_err, ms and plain_ms."""
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, knn
    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one
    from pointcloudmatters_tpu_torch.ops import pointops

    res = {}
    batch = build_batch(batch_size=4, n_points=N_POINTS, seed=0, with_actions=False)
    xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
    mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)

    idx = fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)
    idx_p = pointops.farthest_point_sampling_padded_plain(xyz, mask, 2048)
    torch.cuda.synchronize()
    fps_err = (idx.long() - idx_p.long()).abs().max().item()
    if fps_err != 0:
        raise AssertionError(f"FPS kernel disagrees with its plain version: "
                             f"{(idx != idx_p).sum().item()} indices differ")
    res["fps"] = dict(
        max_abs_err=float(fps_err),
        ms=cuda_ms(lambda: fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048), 5),
        plain_ms=cuda_ms(
            lambda: pointops.farthest_point_sampling_padded_plain(xyz, mask, 2048), 2),
    )
    log(f"fps     B=4 N={N_POINTS}->2048: index-exact; kernel "
        f"{res['fps']['ms']:.3f} ms, plain {res['fps']['plain_ms']:.3f} ms")

    new_xyz = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    ki, kd = knn.knn_query_padded_cuda(new_xyz, xyz, mask, 16)
    pi, pd = pointops.knn_query_padded_plain(new_xyz, xyz, mask, 16)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        raise AssertionError(f"kNN kernel indices disagree with its plain "
                             f"version at {(ki != pi).sum().item()} places")
    rel = ((kd - pd).abs() / pd.abs().clamp_min(1e-30)).max().item()
    if rel > 1e-6:
        raise AssertionError(f"kNN kernel d2 off by {rel:.3e} relative")
    res["knn"] = dict(
        max_abs_err=(kd - pd).abs().max().item(),
        ms=cuda_ms(lambda: knn.knn_query_padded_cuda(new_xyz, xyz, mask, 16), 5),
        plain_ms=cuda_ms(
            lambda: pointops.knn_query_padded_plain(new_xyz, xyz, mask, 16), 2),
    )
    log(f"knn     B=4 M=2048 N={N_POINTS} k=16: indices exact, d2 rel err "
        f"{rel:.3e}; kernel {res['knn']['ms']:.3f} ms, plain "
        f"{res['knn']['plain_ms']:.3f} ms")

    rng = np.random.RandomState(0)

    def qkv(B, H, L, dh):
        return [torch.from_numpy(rng.randn(B, H, L, dh).astype(np.float32)).to(dev)
                for _ in range(3)]

    for B, H, L, dh in ((4, 8, 2051, 64), (4, 4, 2051, 128)):
        q, k, v = qkv(B, H, L, dh)
        scale = dh ** -0.5
        err = (one.oneshot_attention_cuda(q, k, v, scale)
               - one.oneshot_attention_plain(q, k, v, scale)).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"attention kernel (dh={dh}) off by {err:.3e}")
        log(f"attn    B={B} H={H} L={L} dh={dh} f32: max abs err {err:.3e}")
        if dh == 64:
            res["attention_fwd"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: one.oneshot_attention_cuda(q, k, v, scale), 5),
                plain_ms=cuda_ms(lambda: one.oneshot_attention_plain(q, k, v, scale), 5),
            )
            log(f"attn    kernel {res['attention_fwd']['ms']:.3f} ms, plain "
                f"{res['attention_fwd']['plain_ms']:.3f} ms")
    # keys padded with junk and masked by l_actual, Lq != Lk
    q = qkv(2, 8, 100, 64)[0]
    k, v = qkv(2, 8, 700, 64)[1:]
    k[:, :, 650:] *= 1e3
    err = (one.oneshot_attention_cuda(q, k, v, 0.125, l_actual=650)
           - one.oneshot_attention_plain(q, k[:, :, :650], v[:, :, :650], 0.125)
           ).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"attention kernel with a masked key tail off by {err:.3e}")
    log(f"attn    Lq=100 Lk=700 l_actual=650: max abs err {err:.3e}")
    return res


def serve(dev) -> dict:
    """Phase 4: the flagship policy through BCModule.predict."""
    import torch

    from pointcloudmatters_tpu_torch import ops
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule

    module = BCModule(build_flagship(seed=0, device=dev))
    n_params = sum(p.numel() for p in module.policy.parameters())
    if n_params != 24_124_456:
        raise AssertionError(f"flagship has {n_params} parameters")
    requests = [build_batch(batch_size=1, n_points=N_POINTS, seed=s,
                            with_actions=False) for s in (1, 2, 3)]
    big = build_batch(batch_size=BIG_BATCH, n_points=N_POINTS, seed=0,
                      with_actions=False)
    module.predict(requests[0])  # warm-up: cuBLAS handles, library loads
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    answers = []
    for obs in requests + [big]:
        t0 = time.perf_counter()
        a_hat = module.predict(obs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        B = obs["qpos"].shape[0]
        if tuple(a_hat.shape) != (B, 100, 7) or not torch.isfinite(a_hat).all():
            raise AssertionError(f"a_hat {tuple(a_hat.shape)} at B={B} is not a "
                                 f"finite (B, 100, 7)")
        answers.append(a_hat)
        log(f"predict B={B:2d} N={N_POINTS}: {ms:.2f} ms")
    launches = ops.launch_counts()
    log(f"launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")

    with plain_kernels():
        a_plain = module.predict(big)
    torch.cuda.synchronize()
    err = (answers[-1] - a_plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"B={BIG_BATCH} predict with kernels vs plain: {err:.3e}")
    log(f"predict B={BIG_BATCH} kernels vs plain versions: max abs diff {err:.3e}")

    small = dict(hidden_dim=32, npoints=64, nsample=4, chunk=5, enc_layers=2,
                 dec_layers=3, nhead=4)
    obs = build_batch(batch_size=2, n_points=600, chunk=5, seed=4, with_actions=False)
    ref = BCModule(build_flagship(**small, seed=1)).predict(obs)
    got = BCModule(build_flagship(**small, seed=1, device=dev)).predict(obs).cpu()
    err_small = (got - ref).abs().max().item()
    if not err_small <= 1e-4:
        raise AssertionError(f"small policy on the card vs on the CPU: {err_small:.3e}")
    log(f"small policy on the card vs the CPU: max abs diff {err_small:.3e}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pointcloudmatters_tpu_torch import _build

    log(card_line())  # name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    res = check_kernels(dev)
    launches = serve(dev)

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=tpu,
             launches=launches[name], **res[name])
        for name, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
