#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: SpUNet. Builds the kernels, then
runs (a) SpUNet alone, (b)-(d) ACT over SpUNet (``predict``, the bf16 step
and the kernels-vs-plain step, the ``pre_sample`` variant), (e)
``train.main`` on scratch_spunet_pcd, (f) pretrained_ponderv2_pcd from a
fake local file and (g) the Diffusion Policy over SpUNet, printing what
``chip_smoke.py`` prints for them and each path's launches. Each part runs
even where an earlier one failed; the exit code is 1 if any failed::

    python3 tools/spunet_phase.py [part ...]   # parts: a bcd e f g (default all)
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

PARTS = {"a": chip_smoke.spunet_alone, "bcd": chip_smoke.spunet_act,
         "e": chip_smoke.train_cli_spunet, "f": chip_smoke.spunet_ponderv2,
         "g": chip_smoke.dp_spunet}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("spunet_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
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
            chip_smoke.log(f"spunet  part {part}: {time.perf_counter() - t0:.1f} s"
                           + (" FAILED" if part in failed else ""))
            torch.cuda.empty_cache()
    print(json.dumps({part: {path: {k: n for k, n in counts.items() if n}
                             for path, counts in r.items()} if part != "a" else r
                      for part, r in results.items() if isinstance(r, dict)}, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
