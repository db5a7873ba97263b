#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py`` phase 10's fit goes, on one GPU.

    python3 scripts/profile_torch_fit.py [--workers 0 2 4 8] [--repeats 2]

Builds phase 10's flagship task module and data (``ManiSkill2ACTBCModule``,
``"bf16-mixed"``, B=8, ``accumulate_grad_batches=2``, the ported pipeline
over synthetic demos of one 128 x 128 camera), warms it with one fit, then:

1. the loader alone: seconds a batch over one epoch, at each ``--workers``;
2. the optimizer steps alone, on batches already on the card: ms a step
   (two micro-steps) by the host clock to ``torch.cuda.synchronize()``, and
   under ``torch.profiler`` the device's kernel time a step and its idle
   share over the kernel span;
3. the fit at each ``--workers``, ``--repeats`` times in turns: ms an
   optimizer step and the loop's share waiting on the loader, as phase 10
   times them.

Needs the card; prints its name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (phase 10's module, data and timing)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.models.bc_module import to_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, nargs="+", default=[0, 2, 4, 8])
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--steps", type=int, default=4, help="optimizer steps timed alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fit: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    _build.build()
    with tempfile.TemporaryDirectory() as root:
        train_set, _ = chip_smoke.fit_datasets(root)
        module = chip_smoke.fit_module(dev)
        data = {w: chip_smoke.fit_data(train_set, workers=w) for w in args.workers}
        chip_smoke.fit_trainer(root, check_val_every_n_epoch=0).fit(
            module, data[chip_smoke.FIT_WORKERS])  # warm-up

        for w, dm in data.items():
            loader = dm.train_dataloader()
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            print(f"loader alone, {w} threads: {(time.perf_counter() - t0) / n * 1e3:.2f} ms "
                  f"a batch of {chip_smoke.FIT_BATCH} over {n}", flush=True)

        batches = iter(data[chip_smoke.FIT_WORKERS].train_dataloader())
        on_card = [to_device(next(batches), dev) for _ in range(2 * args.steps)]
        batches.close()
        trainer = chip_smoke.fit_trainer(root)
        trainer.setup(module, chip_smoke.TOTAL_STEPS)
        walls = []
        for i in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in on_card[2 * i: 2 * i + 2]:
                trainer.train_step(module, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"optimizer steps alone (2 micro-steps, batches on the card): ms "
              f"{[round(w, 2) for w in walls]}", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in on_card[:4]:
                trainer.train_step(module, b)
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == cuda and not (
                           getattr(e, "is_user_annotation", False)
                           or e.key.startswith("Optimizer.")))
        if spans:
            busy, lo, hi = 0, *spans[0]
            for s, e in spans[1:]:
                if s > hi:
                    busy, lo, hi = busy + hi - lo, s, e
                else:
                    hi = max(hi, e)
            busy += hi - lo
            span = hi - spans[0][0]
            print(f"traced 2 optimizer steps: kernel time {busy / 2e3:.3f} ms a step, "
                  f"span {span / 2e3:.3f} ms a step, idle share {1 - busy / span:.4f}",
                  flush=True)
        else:
            print("the trace holds no device events", flush=True)
        del on_card

        for r in range(args.repeats):
            for w in (args.workers if r % 2 == 0 else args.workers[::-1]):
                t = chip_smoke.timed_fit(dev, module, data[w], root)
                print(f"fit, {w} threads: {t['step_ms']:.2f} ms per optimizer step, "
                      f"{t['samples_per_s']:.2f} samples/s, loader wait "
                      f"{100 * t['wait_share']:.1f}% of {t['loop_s']:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
