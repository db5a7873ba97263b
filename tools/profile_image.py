#!/usr/bin/env python3
"""Where the time of ACT over images goes, on one GPU: the f32 train-mode
forward at B=16 of ResNet-50 and ViT-B/16 alone (RGB, as ``chip_smoke.py``
phase 15 (a) times it), then one ``"bf16-mixed"`` training step at B=16
and one f32 ``predict`` at B=1 of each of phase 15's policies
(scratch_resnet50_rgb, scratch_vit_rgb, scratch_multivit_rgbd), on
128 x 128 images.

    python3 tools/profile_image.py [--top 15] [--backbones-only]

After a warm-up of each, times a step and a request by the host clock to
``torch.cuda.synchronize()``, traces one of each with ``torch.profiler``,
and prints what ``tools/profile_dp.py`` prints (kernel time, launches,
idle share, the kernels and ops by device time) and the kernel time by
part: convolutions (cuDNN's), products (GEMMs: the linears, the attention,
the resize), and the elementwise and reduction kernels of everything else
(batch and layer norms, the casts of the mixed-precision step, the
optimizer). Needs the card; prints its name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phase-15 policies, batches and card line)
from profile_dp import _device_us, _report  # noqa: E402  (this directory)

# (part, substrings of the kernel names it holds), tried in order
PARTS = (
    ("convolutions", ("conv", "cudnn", "implicit_gemm", "xmma_fprop", "dgrad", "wgrad",
                      "nhwcToNchw", "nchwToNhwc")),
    ("products (GEMM)", ("gemm", "nvjet", "sm90_xmma", "cutlass", "ampere_", "sgemm",
                         "splitKreduce")),
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudmatters_tpu_torch.entry import init_parameters
    from pointcloudmatters_tpu_torch.models.bc_module import to_device
    from pointcloudmatters_tpu_torch.trainer import Trainer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--top", type=int, default=15, help="kernels and ops listed")
    parser.add_argument("--backbones-only", action="store_true",
                        help="trace the backbones' forwards alone, not the policies")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_image: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def trace(what, run):
        run()
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            run()
        _report(what, prof, wall, args.top)
        parts = _parts(prof)
        total = sum(parts.values())
        chip_smoke.log(f"{what} by part: " + "; ".join(
            f"{name} {ms:.2f} ms ({100 * ms / total:.1f}%)"
            for name, ms in sorted(parts.items(), key=lambda kv: -kv[1])))

    for kind in ("resnet", "vit"):
        net = chip_smoke.image_backbone(kind, 3)
        init_parameters(net, torch.Generator().manual_seed(0))
        net.to(dev)
        x = torch.from_numpy(chip_smoke.image_batch(chip_smoke.IMAGE_BATCH, 3, seed=0)["image"][
            :, 0]).to(dev)

        def forward():
            with torch.no_grad():
                net(x, train=True)
            torch.cuda.synchronize()

        trace(f"{kind} f32 train-mode forward B={chip_smoke.IMAGE_BATCH}", forward)
        del net, x
        torch.cuda.empty_cache()
    if args.backbones_only:
        return 0
    for model, (_, channels) in chip_smoke.IMAGE_POLICIES.items():
        module = chip_smoke.image_module(dev, model)
        trainer = Trainer(precision="bf16-mixed", seed=0)
        trainer.setup(module, chip_smoke.TOTAL_STEPS)
        batch = to_device(chip_smoke.image_batch(chip_smoke.IMAGE_BATCH, channels, seed=0), dev)
        obs = chip_smoke.image_batch(1, channels, seed=1, with_actions=False)

        def step():
            trainer.train_step(module, batch)
            torch.cuda.synchronize()

        def request():
            module.predict(obs)
            torch.cuda.synchronize()

        for what, run in ((f"{model} bf16 step B={chip_smoke.IMAGE_BATCH}", step),
                          (f"{model} predict B=1", request)):
            trace(what, run)
        del module, trainer, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
