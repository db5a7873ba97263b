#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone: SWA, the state-only and masked ACT,
and the library surface. Builds the kernels, then runs (a) ``train.main``
with ``callbacks=stochastic_weight_averaging``, (b) the state-only ACT and
kernels 3/4 at L = 2 and 3, (c) ``ACTPCD(use_mask=True)``, (d) the library
point ops, (e) ``param_dicts``, ``build_optimizer_v2`` and
``TransformerForDiffusion``, printing what ``chip_smoke.py`` prints for
them and each path's launches. Each part runs even where an earlier one
failed; the exit code is 1 if any failed::

    python3 tools/phase18.py [part ...]   # parts: a b c d e (default all)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rlbench_phase  # noqa: E402

chip_smoke = rlbench_phase.chip_smoke
PARTS = {"a": chip_smoke.swa_fit, "b": chip_smoke.state_only_act, "c": chip_smoke.masked_act,
         "d": chip_smoke.library_pointops, "e": chip_smoke.groups_and_tfd}

if __name__ == "__main__":
    sys.exit(rlbench_phase.run_parts("phase18", PARTS, sys.argv[1:]))
