#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: data parallelism, one process a
card. Builds the kernels, then runs (a) an NCCL group of one rank against
no group, (b) two processes on the card under gloo (and under NCCL across
two cards where the machine has them) against a world of one over the
concatenated batch, and (c) the CLI at ``trainer.devices=auto``, printing
what ``chip_smoke.py`` prints for them and each path's launches::

    python3 scripts/ddp_phase.py
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
        print("ddp_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
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
        paths = chip_smoke.train_ddp(dev)
    print(json.dumps({path: {k: n for k, n in counts.items() if n}
                      for path, counts in paths.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
