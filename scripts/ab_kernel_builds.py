#!/usr/bin/env python3
"""Compare the kernels of two builds of the port on one GPU.

    python3 scripts/ab_kernel_builds.py OTHER [--rounds 2] [--knn-only] [--builder-only]

OTHER is a directory holding another copy of ``pointcloudmatters_tpu_torch/``,
for example the parent commit's::

    mkdir -p checkouts/parent
    git archive HEAD~1 pointcloudmatters_tpu_torch | tar -x -C checkouts/parent

In turns (other, this, this, other, and so on, ``--rounds`` pairs), a fresh
process builds one copy's kernels and times by CUDA events, over 20 launches
after a warm-up: bf16 kernel 3 (the oneshot forward, with its row
statistics) and kernel 4 (its backward) at B=4, H=8, L=2051, dh=64, at
dropout 0 and 0.1; bf16 kernel 7 (the fused layer's forward) at B=4,
L=2051, D=512, H=8; and the f32 oneshot backward (kernel 4), the f32 flash
forward (kernel 9, 512-row tiles) and the f32 flash backward's dK/dV
(kernel 10) and dQ (kernel 11) at the same attention shape and rates, each
with its worst error against its plain version at rate 0.1 on the same
seeded inputs in every turn; the f32 oneshot forward (kernel 3, with its
row statistics) at the same shape and rates, and at B=4, H=4, L=2051,
dh=128 (the same flops), with its worst errors; FPS (kernel 1) at B=1,
4 and 32 for N=10240 and at B=4 for N=20480 and 40960, 2048 samples; and
the kNN kernels at k=16 over 2048 FPS queries, kernel 2 at B=1, 4 and 32
for N=10240 on the FPS order, kernel 12 at B=1 and 4 for N=10240 and 20480
on the Morton-sorted queries, kernel 13 at B=1, 4 and 32 for N=10240 on the
FPS order, each with whether its indices equal the plain kNN's
(``--knn-only``: the kNN kernels alone); and the builder forward (kernel 5),
with whether its vmax, vmin and tie bitmap equal the plain version's, and the
routed dW (kernel 6) at
B=4 and 32 on ``chip_smoke.builder_inputs``, with its worst error against
its plain version relative to max |dW| (``--builder-only``: kernels 5 and 6
alone; a build that has ``pad_channels`` is handed the padded view, as its
backward hands it over, so that neither time holds a copy). Then
it compares the
SASS (``cuobjdump -sass``) of every kernel of every library between the
two builds, instruction addresses and encodings dropped, kernels paired by
mangled name (the oneshot kernels' ``Oneshot`` template argument ignored),
and prints one line a kernel: the same, differing (with both line counts),
or in one build only.

Needs the card and the CUDA toolkit (``cuobjdump``); prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FPS_CASES = ((1, 10240), (4, 10240), (32, 10240), (4, 20480), (4, 40960))
KNN_CASES = ((2, 1, 10240), (2, 4, 10240), (2, 32, 10240), (12, 1, 10240), (12, 4, 10240),
             (12, 1, 20480), (12, 4, 20480), (13, 1, 10240), (13, 4, 10240), (13, 32, 10240))
ROUTED_BATCHES = (4, 32)


def fps_times() -> str:
    """FPS times at FPS_CASES."""
    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps

    dev = torch.device("cuda", 0)
    parts = []
    for B, N in FPS_CASES:
        batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
        xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
        mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        ms = chip_smoke.cuda_ms(
            lambda: fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048), 10)
        parts.append(f"B={B} N={N} {ms:.4f} ms")
    return "FPS: " + ", ".join(parts)


def knn_times() -> str:
    """kNN kernels 2 and 13 (FPS-order queries) and kernel 12
    (Morton-sorted) at KNN_CASES, k = 16, M = 2048, with each result's
    agreement with the plain kNN."""
    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch.entry import build_batch
    from pointcloudmatters_tpu_torch.ops import fps, knn, pointops
    from pointcloudmatters_tpu_torch.ops import knn_baseline as kb
    from pointcloudmatters_tpu_torch.ops import knn_chunkskip as kc

    dev = torch.device("cuda", 0)
    parts = []
    for kernel, B, N in KNN_CASES:
        batch = build_batch(batch_size=B, n_points=N, seed=0, with_actions=False)
        xyz = torch.from_numpy(batch["pcds"]["coord"]).to(dev)
        mask = torch.from_numpy(batch["pcds"]["valid"]).to(dev)
        sel = fps.farthest_point_sampling_padded_cuda(xyz, mask, 2048)
        q = torch.gather(xyz, 1, sel.long()[..., None].expand(-1, -1, 3)).contiguous()
        if kernel == 12:
            perm = pointops.spatial_sort_order(q, torch.ones(q.shape[:2], dtype=torch.bool,
                                                             device=dev)).long()
            q = torch.gather(q, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
        run = {2: knn.knn_query_padded_cuda, 12: kc.knn_query_chunkskip_cuda,
               13: kb.knn_query_baseline_cuda}[kernel]
        exact = torch.equal(run(q, xyz, mask, 16)[0],
                            pointops.knn_query_padded_plain(q, xyz, mask, 16)[0])
        ms = chip_smoke.cuda_ms(lambda: run(q, xyz, mask, 16), 20)
        parts.append(f"#{kernel} B={B} N={N} {ms:.4f} ms (exact {exact})")
    return "kNN: " + ", ".join(parts)


def routed_times() -> str:
    """Kernels 5 and 6 at ROUTED_BATCHES on ``chip_smoke.builder_inputs``:
    whether kernel 5's vmax, vmin and tie bitmap equal the plain version's,
    and kernel 6's worst error against its plain version relative to max
    |dW|."""
    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    dev = torch.device("cuda", 0)
    parts = []
    for B in ROUTED_BATCHES:
        x = chip_smoke.builder_inputs(dev, B)
        src, nn_idx, dvx, dvn = x["src"], x["nn_idx"], x["dvx"], x["dvn"]
        fwd = fb.builder_core_cuda(x["g"], x["h"], nn_idx)
        ref = fb.builder_core_plain(x["g"], x["h"], nn_idx)
        exact = all(torch.equal(fwd[i], ref[i]) for i in (0, 1, 3))
        ms = chip_smoke.cuda_ms(lambda: fb.builder_core_cuda(x["g"], x["h"], nn_idx), 20)
        parts.append(f"#5 B={B} {ms:.4f} ms (exact {exact})")
        bm = fwd[3]
        del fwd, ref
        if hasattr(fb, "pad_channels"):
            src = fb.pad_channels(src)[..., :src.shape[-1]]
        ref = fb.routed_dw_plain(x["src"], nn_idx, bm, dvx, dvn)
        err = (fb.routed_dw_cuda(src, nn_idx, bm, dvx, dvn) - ref).abs().max().item()
        ms = chip_smoke.cuda_ms(lambda: fb.routed_dw_cuda(src, nn_idx, bm, dvx, dvn), 10)
        parts.append(f"#6 B={B} {ms:.4f} ms (error {err / ref.abs().max().item():.3e})")
        del x, src, nn_idx, dvx, dvn, bm, ref
        torch.cuda.empty_cache()
    return "builder: " + ", ".join(parts)


def time_build(root: str, knn_only: bool = False, builder_only: bool = False) -> str:
    """One line of the kernel times of the copy under ``root``: its
    package, timed by this tree's ``chip_smoke`` helpers (``cuda_ms``,
    ``builder_inputs``), whatever ``root`` holds beside the package."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import numpy as np
    import torch

    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.ops import flash_attention as fa
    from pointcloudmatters_tpu_torch.ops import fused_mha as fm
    from pointcloudmatters_tpu_torch.ops import oneshot_attention as one

    if not one.__file__.startswith(root):
        raise RuntimeError(f"imported {one.__file__}, not the copy under {root}")
    _build.build()
    if knn_only:
        return knn_times()
    if builder_only:
        return routed_times()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)

    def arr(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(
            dev, torch.bfloat16)

    B, H, L, dh, D = 4, 8, 2051, 64, 512
    q, k, v, dout = (arr(B, H, L, dh) for _ in range(4))
    scale = dh ** -0.5
    parts = []
    for rate in (0.0, 0.1):
        out, m, r = one.oneshot_attention_cuda(q, k, v, scale, None, rate, 11, with_stats=True)
        args = (q, k, v, out, dout, m, r, scale, None, rate, 11)
        fwd = chip_smoke.cuda_ms(lambda: one.oneshot_attention_cuda(
            q, k, v, scale, None, rate, 11, with_stats=True), 20)
        bwd = chip_smoke.cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args), 20)
        parts.append(f"#3 {fwd:.4f} ms, #4 {bwd:.4f} ms at rate {rate}")
    layer = [arr(B, L, D), arr(B, L, D)] + [
        t for _ in range(4) for t in (arr(D, D, std=D ** -0.5), arr(D, std=0.2))]
    fused = chip_smoke.cuda_ms(lambda: fm.fused_mha_cuda(*layer, H, 0.0, 17), 20)
    parts.append(f"#7 {fused:.4f} ms")

    # f32 kernels 3, 4, 9, 10 and 11: times at both rates, worst error at rate 0.1
    q, k, v, dout = (arr(B, H, L, dh).float() for _ in range(4))
    f32 = []
    for rate in (0.0, 0.1):
        out, m, r = one.oneshot_attention_cuda(q, k, v, scale, None, rate, 11, with_stats=True)
        args = (q, k, v, out, dout, m, r, scale, None, rate, 11)
        fwd3 = chip_smoke.cuda_ms(lambda: one.oneshot_attention_cuda(
            q, k, v, scale, None, rate, 11, with_stats=True), 20)
        bwd = chip_smoke.cuda_ms(lambda: one.oneshot_attention_bwd_cuda(*args), 20)
        kw = dict(sm_scale=scale, dropout_rate=rate, dropout_seed=23, block_q=512, block_k=512)
        fwd = chip_smoke.cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 20)
        o, fl, fm = fa.flash_attention_cuda(q, k, v, **kw)
        fargs = (q, k, v, None, None, fl, fm, dout, (o * dout).sum(-1))
        dkv = chip_smoke.cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*fargs, **kw), 20)
        dq = chip_smoke.cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*fargs, **kw), 20)
        f32.append(f"f32 #3 {fwd3:.4f} ms, f32 #4 {bwd:.4f} ms, f32 #9 {fwd:.4f} ms, "
                   f"f32 #10 {dkv:.4f} ms, f32 #11 {dq:.4f} ms at rate {rate}")
    err3 = chip_smoke._max_err(one.oneshot_attention_cuda(q, k, v, scale, None, 0.1, 11),
                               one.oneshot_attention_plain(q, k, v, scale, None, 0.1, 11))
    err4 = max(chip_smoke._max_err(g, p) for g, p in zip(
        one.oneshot_attention_bwd_cuda(*args), one.oneshot_attention_plain_bwd(*args)))
    err9 = chip_smoke._max_err(fa.flash_attention_cuda(q, k, v, **kw)[0],
                               fa.flash_attention_plain(q, k, v, **kw)[0])
    err10 = max(chip_smoke._max_err(g, p) for g, p in zip(
        fa.flash_attention_bwd_dkv_cuda(*fargs, **kw),
        fa.flash_attention_plain_bwd_dkv(*fargs, **kw)))
    err11 = chip_smoke._max_err(fa.flash_attention_bwd_dq_cuda(*fargs, **kw)[0],
                                fa.flash_attention_plain_bwd_dq(*fargs, **kw)[0])
    parts += f32 + [f"f32 worst error at rate 0.1: #3 {err3:.3e}, #4 {err4:.3e}, "
                    f"#9 {err9:.3e}, #10 {err10:.3e}, #11 {err11:.3e}"]

    # f32 kernel 3 at dh 128, the same flops (H=4)
    q, k, v = (arr(B, 4, L, 128).float() for _ in range(3))
    dh128 = []
    for rate in (0.0, 0.1):
        ms = chip_smoke.cuda_ms(lambda: one.oneshot_attention_cuda(
            q, k, v, 128 ** -0.5, None, rate, 11, with_stats=True), 20)
        err = chip_smoke._max_err(one.oneshot_attention_cuda(q, k, v, 128 ** -0.5, None, rate, 11),
                                  one.oneshot_attention_plain(q, k, v, 128 ** -0.5, None, rate, 11))
        dh128.append(f"{ms:.4f} ms (error {err:.3e}) at rate {rate}")
    parts.append("f32 #3 dh 128, H=4: " + ", ".join(dh128))
    parts.append(fps_times())
    parts.append(knn_times())
    parts.append(routed_times())
    return "; ".join(parts)


def sass(root: str, lib: str) -> dict:
    """Instructions by kernel of library ``lib`` of the copy under ``root``,
    the kernels keyed by their mangled names with the oneshot kernels'
    statistics-form argument (``Oneshot``) and the hash of the build's path
    in anonymous namespaces dropped."""
    (so,) = glob.glob(os.path.join(root, "pointcloudmatters_tpu_torch", "build", f"{lib}-*.so"))
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    kernels, lines = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1).replace("NS0_7OneshotE", "")
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", name)  # a path hash
            lines = kernels.setdefault(re.sub(r"T0_$", "", name), [])
        elif lines is not None:
            line = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if line:
                lines.append(line)
    if not kernels:
        raise RuntimeError(f"no kernel in {so}")
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?",
                        help="directory holding another pointcloudmatters_tpu_torch/")
    parser.add_argument("--rounds", type=int, default=2, help="pairs of turns")
    parser.add_argument("--knn-only", action="store_true",
                        help="time the kNN kernels 2, 12 and 13 alone")
    parser.add_argument("--builder-only", action="store_true",
                        help="time the builder kernels 5 and 6 alone")
    parser.add_argument("--time", help=argparse.SUPPRESS)  # one turn, in a fresh process
    args = parser.parse_args()
    if args.time:
        print(time_build(os.path.abspath(args.time), args.knn_only, args.builder_only),
              flush=True)
        return 0

    if not args.other:
        parser.error("OTHER is required")
    sys.path.insert(0, REPO)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    other = os.path.abspath(args.other)
    for i in range(2 * args.rounds):
        root = other if i % 4 in (0, 3) else REPO
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root]
                             + (["--knn-only"] if args.knn_only else [])
                             + (["--builder-only"] if args.builder_only else []),
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"the turn of {root} failed:\n{run.stderr[-4000:]}")
        print(f"{'other' if root == other else 'this '}: {run.stdout.strip()}", flush=True)
    from pointcloudmatters_tpu_torch import _build

    for lib in _build.KERNELS:
        a, b = sass(other, lib), sass(REPO, lib)
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(f"SASS {lib}: {len(a)} / {len(b)} kernels (other / this), "
              f"{len(differ)} differ", flush=True)
        for name in sorted(a.keys() | b.keys()):
            if name not in b:
                state = f"only in other ({len(a[name])} lines)"
            elif name not in a:
                state = f"only in this ({len(b[name])} lines)"
            elif a[name] == b[name]:
                state = f"same ({len(a[name])} lines)"
            else:
                state = f"differs ({len(a[name])} / {len(b[name])} lines)"
            print(f"  {name}: {state}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
