#!/usr/bin/env python3
"""Where the time of ACT over SpUNet goes, on one GPU: one ``"bf16-mixed"``
training step at B=8 and one f32 ``predict`` at B=1 of ``chip_smoke.py``
phase 14's model (scratch_spunet_pcd) on its grid-sampled clouds.

    python3 tools/profile_spunet.py [--top 25]

After a warm-up of each, times a step and a request by the host clock to
``torch.cuda.synchronize()``, traces one of each with ``torch.profiler``,
and prints what ``tools/profile_dp.py`` prints (kernel time, launches,
idle share, the kernels and ops by device time) and the kernel time by
part: SpUNet's sparse gathers and scatters (gathers, index selects,
scatters, the concatenations of its padded rows), its products (GEMMs),
its sorts and searches, FPS (kernel 1), kNN (kernel 2), attention (kernels
3 and 4), and the elementwise and reduction kernels of everything else
(batch norms, casts, the optimizer). Needs the card; prints its name and
power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase-14 module, shapes and card line)
from profile_dp import _device_us, _report  # noqa: E402  (this directory)

# (part, substrings of the kernel names it holds), tried in order
PARTS = (
    ("FPS #1", ("fps_cluster",)),
    ("kNN #2", ("knn_group", "records_kernel")),
    ("attention #3/#4", ("fwd_kernel", "dkdv_kernel", "dq_kernel", "attn_")),
    ("products (GEMM)", ("gemm", "nvjet", "sm90_xmma", "cutlass", "ampere_", "sgemm",
                         "splitKreduce")),
    ("sorts and searches", ("sort", "Sort", "searchsorted", "scan", "cummax")),
    ("gathers and scatters", ("index", "gather", "scatter", "CatArray", "cat_")),
)


def _parts(prof) -> dict:
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        part = next((name for name, keys in PARTS if any(k in e.key for k in keys)),
                    "elementwise and reductions")
        out[part] = out.get(part, 0.0) + _device_us(e) / 1e3
    return out


def _report_parts(what: str, prof) -> None:
    parts = _parts(prof)
    total = sum(parts.values())
    chip_smoke.log(f"{what} by part: " + "; ".join(
        f"{name} {ms:.2f} ms ({100 * ms / total:.1f}%)"
        for name, ms in sorted(parts.items(), key=lambda kv: -kv[1])))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--top", type=int, default=25, help="kernels and ops listed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_spunet: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    module = chip_smoke.spunet_module(dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    trainer = Trainer(precision="bf16-mixed", seed=0)
    trainer.setup(module, chip_smoke.TOTAL_STEPS)
    batch = to_device(chip_smoke.spunet_batch(chip_smoke.SPUNET_BATCH, seed=0), dev)

    def step():
        trainer.train_step(module, batch)
        torch.cuda.synchronize()

    obs = chip_smoke.spunet_batch(1, seed=1, with_actions=False)

    def request():
        module.predict(obs)
        torch.cuda.synchronize()

    for what, run in ((f"bf16 step B={chip_smoke.SPUNET_BATCH}", step), ("predict B=1", request)):
        run()
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            run()
        _report(what, prof, wall, args.top)
        _report_parts(what, prof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
