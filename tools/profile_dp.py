#!/usr/bin/env python3
"""Where the time of the port's Diffusion Policy goes, on one GPU: one
``predict`` request (the whole reverse chain) and one ``"bf16-mixed"``
training step of ``chip_smoke.py`` phase 13's full-width DP.

    python3 tools/profile_dp.py [--batch 1] [--train-batch 64] [--top 25]

After a warm-up of each, times a request and a step by the host clock to
``torch.cuda.synchronize()``, then traces one of each with
``torch.profiler`` and prints the kernels' device time, their launches, the
device's idle share of the traced span, and the device time by kernel and
by op. Needs the card; prints its
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase-13 module, shapes and card line)


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def _report(what: str, prof, wall_ms: float, top: int) -> None:
    """The kernels' device time (a kernel's time also shows on the op that
    launched it: only the kernels count), their launches, the busy share
    of the span from the first kernel's start to the last one's end, and
    the kernels and the ops by device time."""
    from torch.autograd import DeviceType

    def kernel(e) -> bool:
        return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer."))

    averages = prof.key_averages()
    kernels = [e for e in averages if kernel(e)]
    total = sum(_device_us(e) for e in kernels)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if kernel(e))
    busy, lo, hi = 0, *spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    span = hi - spans[0][0]
    chip_smoke.log(f"{what}: {wall_ms:.2f} ms by the host clock; traced: {len(spans)} kernel "
                   f"launches, {total / 1e3:.2f} ms of kernel time, busy {busy / 1e3:.2f} ms "
                   f"of a {span / 1e3:.2f} ms span (idle share {1 - busy / span:.4f})")
    for title, rows in (("by kernel", kernels),
                        ("by op", [e for e in averages if e.device_type != DeviceType.CUDA])):
        chip_smoke.log(f"  {title}:")
        for e in sorted(rows, key=_device_us, reverse=True)[:top]:
            chip_smoke.log(f"  {_device_us(e) / 1e3:9.3f} ms {100 * _device_us(e) / total:5.1f}% "
                           f" {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.entry import build_dp_batch
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1, help="a request's batch")
    parser.add_argument("--train-batch", type=int, default=chip_smoke.DP_BATCH)
    parser.add_argument("--top", type=int, default=25, help="ops listed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_dp: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    module = chip_smoke.dp_module(dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    obs = build_dp_batch(args.batch, chip_smoke.DP_OBS_STEPS, chip_smoke.DP_POINTS, seed=1,
                         with_actions=False)

    def request():
        module.predict(obs, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()

    request()
    t0 = time.perf_counter()
    request()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=activities) as prof:
        request()
    _report(f"predict B={args.batch}", prof, wall, args.top)

    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, chip_smoke.TOTAL_STEPS)
    batch = to_device(build_dp_batch(args.train_batch, chip_smoke.DP_OBS_STEPS,
                                     chip_smoke.DP_POINTS, seed=0), dev)

    def step():
        trainer.train_step(module, batch)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=activities) as prof:
        step()
    _report(f"train bf16-mixed B={args.train_batch}", prof, wall, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
