#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: RLBench under both heads. Builds the
kernels, writes the phase's episodes, then runs (a) ACT over PointNet's
``predict``, ``"bf16-mixed"`` step, kernels 1-4 on the path against their
plain versions and the card against the CPU, (b) the RLBench Diffusion
Policy's ``predict`` and step and its checkpoint, (c) ``train.main`` on
three RLBench ACT compositions, (d) ``test_rlbench_act`` / ``test_rlbench_dp``
against a fake task (needs (b) and (c)), (e) the flagship's rollout
validation at 1 and 4 envs, (f) a profiled fit, printing what
``chip_smoke.py`` prints for them and each path's launches. Each part runs
even where an earlier one failed; the exit code is 1 if any failed::

    python3 tools/rlbench_phase.py [part ...]   # parts: a b c d e f (default all)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PARTS = {"a": chip_smoke.rlbench_act, "b": chip_smoke.rlbench_dp,
         "c": chip_smoke.train_cli_rlbench, "d": chip_smoke.rlbench_eval,
         "e": chip_smoke.rlbench_rollouts, "f": chip_smoke.rlbench_profiled_fit}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("rlbench_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from pointcloudmatters_tpu_torch import _build

    chip_smoke.log(chip_smoke.card_line())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    built = _build.build()
    chip_smoke.log(f"built {sorted(built) or 'nothing (cached)'} in "
                   f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.TemporaryDirectory()
    chip_smoke.rlbench_data(tmp.name)
    results, failed = {}, []
    with chip_smoke.knn_impl(None):
        for part in argv or list(PARTS):
            t0 = time.perf_counter()
            try:
                results[part] = PARTS[part](dev)
            except Exception:  # report every part's failure, then exit non-zero
                traceback.print_exc()
                failed.append(part)
            chip_smoke.log(f"rlbench part {part}: {time.perf_counter() - t0:.1f} s"
                           + (" FAILED" if part in failed else ""))
            torch.cuda.empty_cache()
    tmp.cleanup()
    print(json.dumps({part: {path: {k: n for k, n in counts.items() if n}
                             for path, counts in r.items()} for part, r in results.items()}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
