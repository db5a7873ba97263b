#!/usr/bin/env python3
"""Kernel 6, the routed dW (``csrc/fused_builder.cu`` ``routed_dw_kernel``),
at several split counts and flush intervals, on one GPU.

    python3 scripts/routed_dw_sweep.py [--batches 4,32] [--splits 16,33,66,132]
                                       [--flush 0,1,2,4]

For each batch B it builds the builder's phase-3 inputs of ``chip_smoke.py``
(``builder_inputs``: B clouds of 10,240 points, 2048 queries, K = 16 with
holes, all-hole and one-live-neighbour queries, Cin = 515, D = 512), the tie
bitmap by kernel 5 and the plain routed dW; then, for every split count and
flush interval (stages of 4 (b, m) pairs between two flushes of the stage
sums into the f32 accumulators; 0: one flush, at the end), the kernel's
worst error against the plain version relative to max |dW|, whether two
launches give the same bits, the share of (block, stage) tiles that ran the
w_lo product and the time by CUDA events over 10 launches after a warm-up.
The flush interval is the source's ``kFlush``: each interval is a copy of
``csrc/fused_builder.cu`` with that constant edited, built with nvcc into
the package's build directory (``probe_routed_dw.build``; 0 sets it past
any stage count). ``ops.fused_builder`` takes ``routed_dw_splits(B, M)``
splits and ``ROUTED_FLUSH``; those rows are marked. The launches go
straight to the C entries; they are not counted in ``ROUTED_LAUNCHES``.

Needs the card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

_FLUSH = "constexpr int kFlush = {};"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="4,32")
    parser.add_argument("--splits", default="16,33,66,132")
    parser.add_argument("--flush", default="0,1,2,4")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from probe_routed_dw import build, load
    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    if not torch.cuda.is_available():
        print("routed_dw_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    shipped = _FLUSH.format(fb.ROUTED_FLUSH)
    flushes = [int(f) for f in args.flush.split(",")]
    procs = {f: build(f"flush{f}", [(shipped, _FLUSH.format(f if f > 0 else 1 << 30))],
                      _build.BUILD_DIR) for f in flushes}
    libs = {f: load(f"flush{f}", proc, _build.BUILD_DIR)[0] for f, proc in procs.items()}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B in (int(b) for b in args.batches.split(",")):
        x = chip_smoke.builder_inputs(dev, B)
        nn_idx, dvx, dvn = x["nn_idx"], x["dvx"], x["dvn"]
        bm = fb.builder_core_cuda(x["g"], x["h"], nn_idx)[3]
        src = x["src"]
        _, M, K = nn_idx.shape
        N, Cin, D = src.shape[1], src.shape[2], bm.shape[2]
        ref = fb.routed_dw_plain(src, nn_idx, bm, dvx, dvn)
        top = ref.abs().max().item()
        srcp = fb.pad_channels(src)
        chosen = (fb.routed_dw_splits(B, M), fb.ROUTED_FLUSH)
        print(f"B={B} M={M} K={K} Cin={Cin} (pitch {srcp.shape[2]}) D={D}: max |dW| "
              f"{top:.4e}; chosen splits {chosen[0]}, flush {chosen[1]}; pad_channels "
              f"{chip_smoke.cuda_ms(lambda: fb.pad_channels(src), 10):.4f} ms", flush=True)
        out = torch.empty((Cin, D), dtype=torch.float32, device=dev)
        counts = torch.zeros((2,), dtype=torch.int32, device=dev)
        for splits in (int(s) for s in args.splits.split(",")):
            part = torch.empty((splits, Cin, D), dtype=torch.float32, device=dev)
            for flush in flushes:

                def run(cnt=None, lib=libs[flush]):
                    err = lib.pcm_routed_dw(srcp.data_ptr(), nn_idx.data_ptr(), bm.data_ptr(),
                                            dvx.data_ptr(), dvn.data_ptr(), part.data_ptr(),
                                            out.data_ptr(), cnt, B, N, M, K, Cin,
                                            srcp.shape[2], D, splits, dev.index, stream)
                    if err:
                        raise RuntimeError(f"pcm_routed_dw: CUDA error {err}")

                counts.zero_()
                run(counts.data_ptr())
                first = out.clone()
                run()
                same = torch.equal(first, out)
                err = (first - ref).abs().max().item() / top
                lo, tiles = (int(v) for v in counts.tolist())
                ms = chip_smoke.cuda_ms(run, 10)
                mark = " (chosen)" if (splits, flush) == chosen else ""
                print(f"  splits {splits:3d} flush {flush}: {ms:.4f} ms, error "
                      f"{err:.3e} of max |dW|, relaunch {'bit-identical' if same else 'DIFFERS'}, "
                      f"w_lo product in {lo} of {tiles} tiles{mark}", flush=True)
        del x, src, srcp, nn_idx, bm, dvx, dvn, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
