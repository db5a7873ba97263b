#!/usr/bin/env python3
"""Where kernel 6's time goes (``csrc/fused_builder.cu`` ``routed_dw_kernel``),
on one GPU: the shipped build beside variants with parts of a stage removed.

    python3 scripts/probe_routed_dw.py [--batches 4,32] [--rounds 2]

Each variant is a copy of ``csrc/fused_builder.cu`` edited here and built
with nvcc into the package's build directory:

- ``no_weights``: no weight build (w_hi left as it is) and no w_lo product;
- ``no_products``: no ``ldmatrix`` or ``mma`` (and no w_lo product);
- ``loads_only``: neither of those: the source-row and pair-data loads, the
  barriers and the flushes;
- ``products_only``: no loads, no weight build, no w_lo product;
- ``cols64``: the shipped kernel at 64-column tiles (128 threads, two
  blocks an SM, a 4-stage ring).

The variants' results are wrong by construction; only the shipped build's
error against ``routed_dw_plain`` is printed, and each variant's registers,
stack frame and spills (ptxas's lines for its ``routed_dw_kernel`` entry;
``chip_smoke.py`` phase 2 prints the shipped build's).
Every build takes the flagship inputs of ``chip_smoke.builder_inputs`` (B
clouds, Cin = 515, D = 512, K = 16) with ``routed_dw_splits``, timed by CUDA events
over 10 launches after a warm-up, in turns (shipped first and last). Then
the shipped build at row pitches 528, 576 and 640 (the C entry takes the
pitch). Needs the card and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (anchor in the source, replacement) edits of each part that a variant drops
_DROP = {
    "loads": [("    if (st >= n_stages) return;\n",
               "    if (st >= n_stages) return;\n    return;\n")],
    "weights": [("      if (next)\n        pw.hi_clear(", "      if (false)\n        pw.hi_clear("),
                ("    if (next) pw.hi_set(", "    if (false) pw.hi_set("),
                ("    pw.hi_clear(s.w_hi[0], wq, wd, K, 0, K);\n    pw.hi_set(s.w_hi[0], wq, wd, K, kmask);\n",
                 "")],
    "products": [("      // the k step's fragments, then its products (the small terms first)\n",
                  "      continue;\n")],
    "lo": [("    const bool lo = __syncthreads_or(has_lo);",
            "    __syncthreads();\n    const bool lo = false;")],
    "cols64": [("constexpr int kTD = 128;", "constexpr int kTD = 64;"),
               ("constexpr int kRing = 5;", "constexpr int kRing = 4;")],
}
VARIANTS = {"no_weights": ("weights", "lo"), "no_products": ("products", "lo"),
            "loads_only": ("weights", "products", "lo"),
            "products_only": ("loads", "weights", "lo"), "cols64": ("cols64",)}


def build(name: str, edits: list, out_dir: str) -> subprocess.Popen:
    """Start nvcc on a copy of ``csrc/fused_builder.cu`` with each (old, new)
    of ``edits`` made once, into ``out_dir/routed_probe_<name>.so``."""
    from pointcloudmatters_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "fused_builder.cu")) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source has no single {old!r}")
        src = src.replace(old, new)
    path = os.path.join(out_dir, f"routed_probe_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", path[:-3] + ".so", path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def load(name: str, proc: subprocess.Popen, out_dir: str) -> tuple:
    """Wait for ``build``'s nvcc -> (the library, its argtypes set; the
    ptxas usage of its ``routed_dw_kernel`` entry: the lines between that
    entry's "Compiling entry function" line and the next entry's)."""
    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    entry, usage = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if "routed_dw_kernel" in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            usage.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage["registers"] = int(m[1])
    if set(usage) != {"stack", "spill_stores", "spill_loads", "registers"}:
        raise RuntimeError(f"no ptxas usage of routed_dw_kernel for {name}:\n{log}")
    lib = ctypes.CDLL(os.path.join(out_dir, f"routed_probe_{name}.so"))
    lib.pcm_routed_dw.argtypes = fb._lib().pcm_routed_dw.argtypes
    lib.pcm_routed_dw.restype = ctypes.c_int
    return lib, usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", default="4,32")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    if not torch.cuda.is_available():
        print("probe_routed_dw: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {name: build(name, [e for part in parts for e in _DROP[part]], _build.BUILD_DIR)
             for name, parts in VARIANTS.items()}
    libs = {"shipped": fb._lib()}
    for name, proc in procs.items():
        libs[name], usage = load(name, proc, _build.BUILD_DIR)
        print(f"{name}: {usage['registers']} registers, stack frame {usage['stack']} B, "
              f"spill stores {usage['spill_stores']} B, loads {usage['spill_loads']} B",
              flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B in (int(b) for b in args.batches.split(",")):
        x = chip_smoke.builder_inputs(dev, B)
        nn_idx, dvx, dvn = x["nn_idx"], x["dvx"], x["dvn"]
        bm = fb.builder_core_cuda(x["g"], x["h"], nn_idx)[3]
        _, M, K = nn_idx.shape
        N, Cin, D = x["src"].shape[1], x["src"].shape[2], bm.shape[2]
        ref = fb.routed_dw_plain(x["src"], nn_idx, bm, dvx, dvn)
        splits = fb.routed_dw_splits(B, M)
        part = torch.empty((splits, Cin, D), dtype=torch.float32, device=dev)
        out = torch.empty((Cin, D), dtype=torch.float32, device=dev)

        def runner(lib, src):
            def run():
                err = lib.pcm_routed_dw(src.data_ptr(), nn_idx.data_ptr(), bm.data_ptr(),
                                        dvx.data_ptr(), dvn.data_ptr(), part.data_ptr(),
                                        out.data_ptr(), None, B, N, M, K, Cin, src.stride(1),
                                        D, splits, dev.index, stream)
                if err:
                    raise RuntimeError(f"pcm_routed_dw: CUDA error {err}")
            return run

        src = fb.pad_channels(x["src"])
        order = ["shipped"] + list(VARIANTS) + ["shipped"]
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(chip_smoke.cuda_ms(runner(libs[name], src), 10))
            order.reverse()
        runner(libs["shipped"], src)()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        print(f"B={B} splits {splits}: shipped error {err:.3e} of max |dW|", flush=True)
        for name, ts in times.items():
            print(f"  {name:14s} {min(ts):.4f}-{max(ts):.4f} ms", flush=True)
        for pitch in (528, 576, 640):
            padded = torch.zeros((B, N, pitch), dtype=torch.bfloat16, device=dev)
            padded[..., :Cin] = x["src"]
            ms = chip_smoke.cuda_ms(runner(libs["shipped"], padded[..., :Cin]), 10)
            print(f"  pitch {pitch}: {ms:.4f} ms", flush=True)
            del padded
        del x, ref, src, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
