#!/usr/bin/env python3
"""The exact kNN kernels 2 (``csrc/knn.cu``), 12 (``csrc/knn_chunkskip.cu``)
and 13 (``csrc/knn_baseline.cu``) at every lane-group size S, and kernels 12
and 13 at every query tile TQ, on one GPU.

    python3 scripts/knn_group_sweep.py [--k 16] [--batches 1,4,32] [--kernels 2,12,13]

For each batch B it builds B clouds of 10,240 and of 20,480 points
(``entry.build_batch``) and their 2048 FPS queries, k = 16 results, and
prints the S (and TQ) that ``ops/knn.py``, ``ops/knn_chunkskip.py`` and
``ops/knn_baseline.py`` choose; then kernel 2 on the queries in FPS order at N = 10,240 for every S,
and kernel 12 on the Morton-sorted queries at both cloud sizes for every S
and every TQ it takes (32 <= TQ * S <= 256), and kernel 13 on the queries in
FPS order at N = 10,240 for every S and TQ: whether each is index-exact
against ``knn_query_padded_plain`` with d2 bit-equal, kernel 12's skipped
(tile, chunk) pairs against its plain version's at that TQ and the share
pruned by the boxes, and its time by CUDA events over 10 launches after a
warm-up. The launches go straight to the C entries with the forced shape;
they are not counted in the wrappers' ``LAUNCHES``.

Needs the card; prints its name and power limit first. Exits 1 if a shape
is not exact.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--batches", default="1,4,32")
    parser.add_argument("--kernels", default="2,12,13", help="of kernels 2, 12 and 13")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps
    from pointcloudmatters_tpu_torch.ops import knn as kn
    from pointcloudmatters_tpu_torch.ops import knn_baseline as kb
    from pointcloudmatters_tpu_torch.ops import knn_chunkskip as kc
    from pointcloudmatters_tpu_torch.ops import pointops

    if not torch.cuda.is_available():
        print("knn_group_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib2, lib12, lib13 = kn._lib(), kc._lib(), kb._lib()
    k, fails = args.k, 0
    kernels = {int(x) for x in args.kernels.split(",")}
    for B in (int(b) for b in args.batches.split(",")):
        for N in (10240, 20480):
            if N != 10240 and 12 not in kernels:
                continue
            batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
            xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
            mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
            sel = fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)
            q = torch.gather(xyz, 1, sel.long()[..., None].expand(-1, -1, 3)).contiguous()
            perm = pointops.spatial_sort_order(q, torch.ones(q.shape[:2], dtype=torch.bool,
                                                             device=dev)).long()
            q_sorted = torch.gather(q, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
            M = q.shape[1]
            S12, TQ12 = kc.launch_shape(B, M, k, dev.index)
            S13, TQ13 = kb.launch_shape(B, M, k, dev.index)
            print(f"B={B} N={N} k={k}: chosen S={kn.launch_group(B, M, k, dev.index)} "
                  f"(kernel 2), S={S12}, TQ={TQ12} (kernel 12), S={S13}, TQ={TQ13} "
                  f"(kernel 13)", flush=True)
            rec = torch.empty((B, N, 4), dtype=torch.float32, device=dev)
            rec_idx = torch.empty((B, N), dtype=torch.int32, device=dev)
            idx = torch.empty((B, M, k), dtype=torch.int32, device=dev)
            d2 = torch.empty((B, M, k), dtype=torch.float32, device=dev)
            boxes = torch.empty((B, -(-N // kc.chunk_points(N)), kc.BOX_FLOATS),
                                dtype=torch.float32, device=dev)
            counts = torch.zeros((2,), dtype=torch.int32, device=dev)

            refs = {id(qq): pointops.knn_query_padded_plain(qq, xyz, mask, k)
                    for qq in (q, q_sorted)}
            plain_skipped = {}

            def check(what, qq):
                ri, rd = refs[id(qq)]
                ok = torch.equal(idx, ri) and torch.equal(d2, rd)
                if not ok:
                    print(f"  {what}: NOT EXACT at {(idx != ri).sum().item()} indices, "
                          f"{(d2 != rd).sum().item()} distances", flush=True)
                return ok

            for S in kn.GROUP_SIZES:
                if 2 not in kernels or N != 10240 or kn.list_rows(k, S) > kn.MAX_ROWS:
                    continue

                def run2():
                    err = lib2.pcm_knn(q.data_ptr(), xyz.data_ptr(), mask.data_ptr(),
                                       rec.data_ptr(), rec_idx.data_ptr(), idx.data_ptr(),
                                       d2.data_ptr(), B, M, N, k, S, dev.index, stream)
                    if err:
                        raise RuntimeError(f"pcm_knn: CUDA error {err}")

                run2()
                fails += not check(f"#2 S={S}", q)
                ms = chip_smoke.cuda_ms(run2, 10)
                print(f"  #2  S={S:2d}: {ms:.4f} ms", flush=True)
            for S in kn.GROUP_SIZES:
                if 12 not in kernels or kn.list_rows(k, S) > kn.MAX_ROWS:
                    continue
                for TQ in (1, 2, 4, 8, 16, 32, 64, 128):
                    if not 32 <= TQ * S <= kc.MAX_THREADS or TQ > kc.MAX_TILE:
                        continue

                    def run12(cnt=None):
                        err = lib12.pcm_knn_chunkskip(
                            q_sorted.data_ptr(), xyz.data_ptr(), mask.data_ptr(),
                            rec.data_ptr(), boxes.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                            cnt, B, M, N, k, S, TQ, dev.index, stream)
                        if err:
                            raise RuntimeError(f"pcm_knn_chunkskip: CUDA error {err}")

                    counts.zero_()
                    run12(counts.data_ptr())
                    skipped, pruned = (int(v) for v in counts.tolist())
                    ok = check(f"#12 S={S} TQ={TQ}", q_sorted)
                    if TQ not in plain_skipped:
                        plain_skipped[TQ] = int(pointops.knn_query_chunkskip_plain(
                            q_sorted, xyz, mask, k, with_skipped=True, tm=TQ)[2])
                    plain = plain_skipped[TQ]
                    if skipped != plain:
                        print(f"  #12 S={S} TQ={TQ}: skipped {skipped}, plain {plain}",
                              flush=True)
                        ok = False
                    fails += not ok
                    pairs = B * -(-M // TQ) * -(-N // kc.chunk_points(N))
                    ms = chip_smoke.cuda_ms(run12, 10)
                    print(f"  #12 S={S:2d} TQ={TQ:3d}: {ms:.4f} ms, skipped "
                          f"{skipped / pairs:.3f} of {pairs} pairs, pruned {pruned / pairs:.3f}",
                          flush=True)
            for S in kn.GROUP_SIZES:
                if 13 not in kernels or N != 10240 or kn.list_rows(k, S) > kn.MAX_ROWS:
                    continue
                for TQ in (1, 2, 4, 8, 16, 32, 64, 128):
                    if not 32 <= TQ * S <= kb.MAX_THREADS or TQ > kb.MAX_TILE:
                        continue

                    def run13():
                        err = lib13.pcm_knn_baseline(
                            q.data_ptr(), xyz.data_ptr(), mask.data_ptr(), rec.data_ptr(),
                            idx.data_ptr(), d2.data_ptr(), B, M, N, k, S, TQ, dev.index,
                            stream)
                        if err:
                            raise RuntimeError(f"pcm_knn_baseline: CUDA error {err}")

                    run13()
                    fails += not check(f"#13 S={S} TQ={TQ}", q)
                    ms = chip_smoke.cuda_ms(run13, 10)
                    print(f"  #13 S={S:2d} TQ={TQ:3d}: {ms:.4f} ms", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
