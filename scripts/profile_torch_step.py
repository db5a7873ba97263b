#!/usr/bin/env python3
"""Where the time of the port's flagship training step goes, on one GPU.

    python3 scripts/profile_torch_step.py [--batch 32] [--points 10240]
        [--precision 32-true|bf16-mixed] [--freeze-backbone]
        [--attention-impl oneshot|fused|flash] [--dropout 0.1]

Builds the flagship of ``chip_smoke.py`` phases 5-7 (dropout 0.1 unless
``--dropout`` says otherwise, AdamW + OneCycleLR over 10,000 steps,
``"32-true"`` unless ``--precision`` says otherwise; ``--freeze-backbone``
for the variant whose token builder takes the data-source kernels under
bf16; ``--attention-impl fused`` for the encoder whose layers run kernels 7
and 8 at dropout 0, ``--attention-impl flash`` for the one whose layers run
kernels 9, 10 and 11) and, after two warm-up steps:

1. times forward, backward and the rest of the step (gradient norm, AdamW,
   schedule) with CUDA events over ``--steps`` steps, and the whole step by
   the host clock to ``torch.cuda.synchronize()``;
2. traces ``--traced`` steps with ``torch.profiler`` and prints device time
   a step by op and by kernel (the attention backward shows as its three kernels:
   the ``D = rowsum(dO * O)`` pre-pass, dK/dV and dQ; the fused layer as its
   GEMM, attention and reduction kernels), the busy share of
   the kernel span (one minus the device's idle share) and the peak device
   memory. The ranges torch's optimizer marks on the device's track
   (``Optimizer.step#...``, user annotations) are listed apart and count
   neither in the device time nor in the busy share.

Needs the card; prints its name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (constants of the flagship step)


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def _annotation(event) -> bool:
    """Whether a device event is a range marked by the host (the optimizer's
    ``Optimizer.step#...``), not a kernel."""
    return bool(getattr(event, "is_user_annotation", False)) or event.key.startswith(
        "Optimizer.")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
    from pointcloudmatters_tpu_torch.models.bc_module import BCModule, to_device
    from pointcloudmatters_tpu_torch.utils.optimizer import global_norm
    from pointcloudmatters_tpu_torch.trainer import Trainer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=chip_smoke.BIG_BATCH)
    parser.add_argument("--points", type=int, default=chip_smoke.N_POINTS)
    parser.add_argument("--steps", type=int, default=3, help="steps timed by events")
    parser.add_argument("--traced", type=int, default=2, help="steps traced")
    parser.add_argument("--top", type=int, default=40, help="ops listed")
    parser.add_argument("--precision", default="32-true")
    parser.add_argument("--freeze-backbone", action="store_true")
    parser.add_argument("--attention-impl", default="oneshot",
                        choices=("oneshot", "fused", "flash"))
    parser.add_argument("--dropout", type=float, default=chip_smoke.ATTN_DROPOUT)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1

    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    module = BCModule(build_flagship(seed=0, dropout=args.dropout, device=dev,
                                     freeze_backbone=args.freeze_backbone,
                                     attention_impl=args.attention_impl),
                      optimizer=chip_smoke.FLAGSHIP_OPT,
                      lr_scheduler=chip_smoke.FLAGSHIP_SCHED)
    trainer = Trainer(precision=args.precision, seed=0)
    trainer.setup(module, chip_smoke.TOTAL_STEPS)
    batch = to_device(build_batch(batch_size=args.batch, n_points=args.points, seed=0), dev)
    for _ in range(2):
        trainer.train_step(module, batch)
    torch.cuda.synchronize()

    # the phases of Trainer.train_step, one CUDA event between each
    params = [p for p in module.policy.parameters() if p.requires_grad]
    phases = {"forward": [], "backward": [], "norm+AdamW+schedule": []}
    walls = []
    for _ in range(args.steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        events[0].record()
        module.optimizer.zero_grad(set_to_none=False)
        out = module.forward_train(batch, trainer.rngs, trainer.compute_dtype)
        events[1].record()
        out["loss"].to(torch.float32).backward()
        events[2].record()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        global_norm([p.grad for p in params])
        module.optimizer.step()
        module.scheduler.step()
        events[3].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        for name, a, b in zip(phases, events[:-1], events[1:]):
            phases[name].append(a.elapsed_time(b))
    print(f"B={args.batch} N={args.points} {args.precision}"
          f"{' frozen backbone' if args.freeze_backbone else ''} {args.attention_impl} "
          f"dropout {args.dropout}: step ms (host clock) "
          f"{[round(w, 3) for w in walls]}", flush=True)
    for name, ms in phases.items():
        print(f"  {name:20s} ms (CUDA events) {[round(t, 3) for t in ms]}", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.traced):
            trainer.train_step(module, batch)
        torch.cuda.synchronize()
    # a kernel's time shows twice: on its own row and on the op that
    # launched it; the total counts the kernels only, not the ranges that
    # torch's optimizer marks on the device's track (user annotations)
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == cuda and not _annotation(e)]
    total = sum(_device_us(e) for e in kernels)
    print(f"device kernel time a step: {total / 1e3 / args.traced:.3f} ms "
          f"(over {args.traced} traced steps)")
    for title, rows in (("by op", [e for e in averages if e.device_type != cuda]),
                        ("by kernel", kernels),
                        ("device ranges, not in the total",
                         [e for e in averages if e.device_type == cuda and _annotation(e)])):
        print(title)
        for e in sorted(rows, key=_device_us, reverse=True)[:args.top]:
            if _device_us(e) == 0:
                break
            print(f"{_device_us(e) / 1e3 / args.traced:10.3f} ms/step "
                  f"{100 * _device_us(e) / total:5.1f}%  n={e.count // args.traced:6d}  "
                  f"{e.key[:100]}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and not _annotation(e))
    if not spans:
        print("the trace holds no device events: time with CUDA events only")
    else:
        busy, lo, hi = 0, *spans[0]
        for s, e in spans[1:]:
            if s > hi:
                busy, lo, hi = busy + hi - lo, s, e
            else:
                hi = max(hi, e)
        busy += hi - lo
        span = hi - spans[0][0]
        print(f"kernel span {span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, "
              f"idle share {1 - busy / span:.4f}")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
