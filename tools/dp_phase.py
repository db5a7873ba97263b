#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: the Diffusion Policy over point
clouds. Builds the kernels, then runs (a) FPS and kNN at the DP's shapes,
(b) ``predict`` at B=1 and B=8, (c) the ``"bf16-mixed"`` step at B=64 and
(d) ``train.main`` on the DP composition, printing what ``chip_smoke.py``
prints for them and each path's launches::

    python3 tools/dp_phase.py
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dp_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from pointcloudmatters_tpu_torch import _build

    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    built = _build.build()
    chip_smoke.log(f"built {sorted(built) or 'nothing (cached)'} in "
                   f"{time.perf_counter() - t0:.1f} s")
    with chip_smoke.knn_impl(None):
        paths, cases = chip_smoke.train_dp(dev)
    print(json.dumps({"launches": {path: {k: n for k, n in counts.items() if n}
                                   for path, counts in paths.items()}, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
