#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the Diffusion Policy over images.
Builds the kernels, then runs (a) each image encoder alone at full width,
(b) ``predict`` of the three image policies, (c) their ``"bf16-mixed"``
step and the f32 step on the card against the CPU, (d) ``train.main`` on
scratch_resnet50_rgbd and scratch_resnet50_pointmap, (e) pretrained_r3m_rgb
and pretrained_vc1_rgb from fake local files, (f) fake reference
checkpoints through the converter, printing what ``chip_smoke.py`` prints
for them and each path's launches. Each part runs even where an earlier
one failed; the exit code is 1 if any failed::

    python3 tools/image_dp_phase.py [part ...]   # parts: a b c d e f (default all)
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PARTS = {"a": chip_smoke.image_dp_encoders, "b": chip_smoke.image_dp_serve,
         "c": chip_smoke.image_dp_steps, "d": chip_smoke.train_cli_image_dp,
         "e": chip_smoke.image_dp_pretrained, "f": chip_smoke.image_dp_converter}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("image_dp_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from pointcloudmatters_tpu_torch import _build

    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    built = _build.build()
    chip_smoke.log(f"built {sorted(built) or 'nothing (cached)'} in "
                   f"{time.perf_counter() - t0:.1f} s")
    results, failed = {}, []
    with chip_smoke.knn_impl(None):
        for part in argv or list(PARTS):
            t0 = time.perf_counter()
            try:
                results[part] = PARTS[part](dev)
            except Exception:  # report every part's failure, then exit non-zero
                traceback.print_exc()
                failed.append(part)
            chip_smoke.log(f"imagedp part {part}: {time.perf_counter() - t0:.1f} s"
                           + (" FAILED" if part in failed else ""))
            torch.cuda.empty_cache()
    print(json.dumps({part: r if part == "a" else {
        path: {k: n for k, n in counts.items() if n} for path, counts in r.items()}
        for part, r in results.items()}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
