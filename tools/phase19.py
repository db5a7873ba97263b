#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone: the reference's scripts on the port, a
per-key image DP that does not pool, and a JAX SGD checkpoint resumed.
Builds the kernels, then runs (a) ``preprocess_rlbench.main`` against the
fake ``rlbench`` and ``train.main`` on the episodes it wrote, kernels 1-4 on
the path's tensors against their plain versions, (b) the RLBench
camera-view sweep's first two commands through ``test_rlbench_act.main``
(needs (a)), (c) both ManiSkill2 sweep scripts, one command each through
``validate.main``, (d) the image DP with a ResNet-18 a camera without
``avg_pool``, card against CPU, (e) an SGD flagship written in JAX's form,
converted and resumed bit for bit, (f) (d)'s model at the shipped widths on
the card alone, printing what ``chip_smoke.py`` prints for them and each
path's launches. Each part runs even where an earlier one
failed; the exit code is 1 if any failed::

    python3 tools/phase19.py [part ...]   # parts: a b c d e f (default all)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rlbench_phase  # noqa: E402

chip_smoke = rlbench_phase.chip_smoke
PARTS = {"a": chip_smoke.preprocessed_rlbench, "b": chip_smoke.rlbench_camera_view,
         "c": chip_smoke.maniskill2_sweeps, "d": chip_smoke.unpooled_image_dp,
         "e": chip_smoke.sgd_round_trip, "f": chip_smoke.unpooled_image_dp_full}

if __name__ == "__main__":
    sys.exit(rlbench_phase.run_parts("phase19", PARTS, sys.argv[1:], before=chip_smoke.p19_root))
