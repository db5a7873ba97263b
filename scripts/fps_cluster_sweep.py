#!/usr/bin/env python3
"""FPS (kernel 1, ``csrc/fps.cu``) at every cluster size and thread count, on
one GPU.

    python3 scripts/fps_cluster_sweep.py

For each case of CASES (B clouds of N points from ``entry.build_batch``,
2048 samples) it prints the cluster size C and threads a CTA T that
``ops/fps.py`` chooses, then, for every C in {1, 2, 4, 8, 16} and every T
of WARPS warps that the kernel takes for that slice (at most 12 points a
thread) and the device holds, how many such clusters it holds at once,
whether the kernel is index-exact against the plain version, and its time
by CUDA events over 10 launches after a warm-up, in ms and microseconds a
round. The launches go straight to the C entry with the
forced (C, T); they are not counted in ``fps.LAUNCHES``.

Needs the card; prints its name and power limit first.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CASES = ((1, 10240), (4, 10240), (32, 10240), (4, 20480), (32, 20480), (4, 40960))
WARPS = (1, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 32)


def main() -> int:
    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, pointops

    if not torch.cuda.is_available():
        print("fps_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    lib = fps._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fails = 0
    for B, N in CASES:
        batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
        xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
        mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        ref = pointops.farthest_point_sampling_padded_plain(xyz, mask, 2048)
        print(f"B={B} N={N}: chosen (C, T) = {fps.launch_shape(B, N, dev.index)}", flush=True)
        for C in (1, 2, 4, 8, 16):
            S = fps.cluster_slice(N, C)
            if S > fps.MAX_SLICE:
                continue
            for T in (32 * w for w in reversed(WARPS)):
                if -(-S // T) > fps.MAX_POINTS_PER_THREAD or T > 32 * -(-S // 32):
                    continue
                fit = fps._active_clusters(dev.index, N, C, T)
                if fit < 1:
                    continue
                out = torch.empty((B, 2048), dtype=torch.int32, device=dev)

                def run():
                    err = lib.pcm_fps(xyz.data_ptr(), mask.data_ptr(), out.data_ptr(), None,
                                      B, N, 2048, C, T, dev.index, stream)
                    if err:
                        raise RuntimeError(f"fps launch: CUDA error {err}")

                run()
                exact = torch.equal(out, ref)
                fails += not exact
                ms = chip_smoke.cuda_ms(run, 10)
                print(f"  C={C:2d} T={T:4d} ({-(-S // T)} points a thread, {fit} clusters "
                      f"fit): index-exact {exact}, {ms:.4f} ms, {ms * 1e3 / 2047:.3f} us a "
                      f"round", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
