"""Readings from which the limits of ``correct`` are set, for one cell, in
one process on the card:

- ``--seeds``: sound runs of the program (set-up, a short window, the
  comparison), each number as the run compares it: the lower readings;
- ``--control-seeds``: the control, the reference one precision below the
  configuration's in the program's place: the upper readings;
- ``--fault-seeds``: a training cell's planted fault, each step on half of
  its batch (the mean over the rest).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds ...] [--fault-seeds ...] [--seconds 2]

Prints one JSON line a reading and, last, each number's largest sound
reading and smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (here, ROOT)]
    import torch

    from benchmark import harness

    dev = torch.device("cuda", 0)
    summary: dict = {}

    def keep(kind, seed, checks, where=None):
        print(json.dumps({"kind": kind, "seed": seed, **checks, "where": where or {}}),
              flush=True)
        for k, v in checks.items():
            summary.setdefault(kind, {}).setdefault(k, []).append(v)

    for seed in args.seeds:
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, dev, time.time())
        keep("sound", seed, {k: c["value"] for k, c in r["checks"].items()})
    for variant, seeds in (("control", args.control_seeds), ("half_batch", args.fault_seeds)):
        for seed in seeds:
            where: dict = {}
            keep(variant, seed, harness.reference_pair(ROOT, args.workload, seed, dev, variant,
                                                       where=where), where)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, **{
        kind: {k: (max(v) if kind == "sound" else min(v)) for k, v in nums.items()}
        for kind, nums in summary.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
