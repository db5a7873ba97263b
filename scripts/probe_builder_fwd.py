#!/usr/bin/env python3
"""Where kernel 5's time goes (``csrc/fused_builder.cu`` ``builder_fwd_kernel``
and its partial sum), on one GPU: a build of the source beside variants with
parts removed.

    python3 scripts/probe_builder_fwd.py [--source PATH] [--batches 4,32] [--rounds 2]
        [--blocks 132,528,1056]

``--source`` is a copy of ``fused_builder.cu`` whose kernel 5 is this one (16-byte
chunks, ``kFwdThreads``; default: the package's).

Each variant is a copy of the source edited here and built with nvcc into
the package's build directory:

- ``everything``: the source as it is (timed first and last);
- ``loads_only``: the nn rows, the h and g loads, folded into one word that
  is stored only if it takes a value it never takes (so nothing is
  dropped by the compiler), no arithmetic and no output stores;
- ``loads_select``: the loads and every computation (vmax, vmin, sg, the
  tie bits, the totals and the partials), folded likewise, no output stores;
- ``sum_alone``: the second kernel, the fixed-order sum of the partial rows,
  alone (the entry skips the first launch);
- ``blocks_<n>`` for each n of ``--blocks``: the source
  with ``kFwdBlocks`` = n, whose results are right too (other partial rows,
  so other totals' last bits).

Only ``everything``'s results are right; its vmax, vmin and tie bitmap are
checked against ``builder_core_plain``. Printed: each variant's registers,
stack frame and spills (ptxas's lines for its ``builder_fwd_kernel``) and
its time by CUDA events over 20 launches after a warm-up, in turns, on
``chip_smoke.builder_inputs`` (B clouds of N = 10240, M = 2048, K = 16, D =
512). Needs the card and nvcc; prints the card's name and power limit
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

_FOLD_STORE = "if (fold == 0x9e3779b9u) vmax_out[0] = __float2bfloat16_rn(0.f);\n"

# variant -> [(start, end, replacement)]: the text from ``start`` through
# ``end`` (each once in the source) becomes ``replacement``; an empty ``end``
# replaces ``start`` alone
_EDITS = {
    "loads_only": [
        ("      uint32_t x[kMaxK][4];\n", "",
         "      uint32_t x[kMaxK][4];\n      uint32_t fold = hp[0];\n"),
        ("      // sg in k order, x = bf16(g - h), vmax, vmin and the totals\n",
         "             make_uint4(bits[4], bits[5], bits[6], bits[7]));\n",
         "#pragma unroll\n      for (int k = 0; k < kMaxK; ++k) {\n"
         "        if (k >= K) break;\n"
         "        fold ^= x[k][0] ^ x[k][1] ^ x[k][2] ^ x[k][3];\n      }\n      "
         + _FOLD_STORE),
    ],
    "loads_select": [
        ("      // the outputs\n",
         "             make_uint4(bits[4], bits[5], bits[6], bits[7]));\n",
         "      uint32_t fold = 0;\n#pragma unroll\n      for (int j = 0; j < 4; ++j)\n"
         "        fold ^= mx[j] ^ mn[j] ^ tmax[j] ^ tmin[j] ^ __float_as_uint(sg[2 * j])"
         " ^ __float_as_uint(sg[2 * j + 1]);\n      " + _FOLD_STORE),
    ],
    "sum_alone": [("  builder_fwd_kernel<<<", "", "  if (false) builder_fwd_kernel<<<")],
}


def edit(src: str, edits: list, name: str) -> str:
    for start, end, new in edits:
        if src.count(start) != 1:
            raise RuntimeError(f"variant {name}: the source has no single {start!r}")
        i = src.index(start)
        j = i + len(start)
        if end:
            if src.count(end) != 1 or src.index(end) < i:
                raise RuntimeError(f"variant {name}: the source has no single {end!r} after "
                                   f"{start!r}")
            j = src.index(end) + len(end)
        src = src[:i] + new + src[j:]
    return src


def build(source: str, name: str, edits: list, out_dir: str) -> subprocess.Popen:
    """Start nvcc on ``source`` edited by ``edits``, into
    ``out_dir/builder_probe_<name>.so``."""
    from pointcloudmatters_tpu_torch import _build

    with open(source) as f:
        src = edit(f.read(), edits, name)
    path = os.path.join(out_dir, f"builder_probe_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(source)),
           "-I", _build.CSRC, "-o", path[:-3] + ".so", path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def load(name: str, proc: subprocess.Popen, out_dir: str) -> tuple:
    """Wait for ``build``'s nvcc -> (the library with its argtypes set, the
    ptxas usage of its ``builder_fwd_kernel`` entry)."""
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    entry, usage = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if "builder_fwd_kernel" in m.group(1) else None
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
    lib = ctypes.CDLL(os.path.join(out_dir, f"builder_probe_{name}.so"))
    lib.pcm_builder_fwd_partials.argtypes = [ctypes.c_int] * 3
    lib.pcm_builder_fwd_partials.restype = ctypes.c_longlong
    lib.pcm_builder_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.pcm_builder_fwd.restype = ctypes.c_int
    return lib, usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", help="a fused_builder.cu (default: the package's)")
    parser.add_argument("--batches", default="4,32")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--blocks", default="132,528,1056",
                        help="kFwdBlocks of the blocks_<n> variants")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pointcloudmatters_tpu_torch import _build
    from pointcloudmatters_tpu_torch.ops import fused_builder as fb

    if not torch.cuda.is_available():
        print("probe_builder_fwd: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    source = os.path.abspath(args.source or os.path.join(_build.CSRC, "fused_builder.cu"))
    with open(source) as f:
        text = f.read()
    if "constexpr int kFwdThreads" not in text:
        raise RuntimeError(f"{source} holds another design of kernel 5")
    print(source, flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tag = f"fwd_{os.getpid()}"
    variants = list(_EDITS.items())
    if args.blocks:
        line = re.search(r"constexpr int kFwdBlocks = \d+;", text).group(0)
        variants += [(f"blocks_{n}", [(line, "", f"constexpr int kFwdBlocks = {int(n)};")])
                     for n in args.blocks.split(",")]
    procs = {name: build(source, f"{tag}_{name}", edits, _build.BUILD_DIR)
             for name, edits in [("everything", [])] + variants}
    libs = {}
    for name, proc in procs.items():
        libs[name], usage = load(f"{tag}_{name}", proc, _build.BUILD_DIR)
        print(f"{name}: {usage.get('registers')} registers, stack frame {usage.get('stack')} "
              f"B, spill stores {usage.get('spill_stores')} B, loads "
              f"{usage.get('spill_loads')} B", flush=True)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B in (int(b) for b in args.batches.split(",")):
        x = chip_smoke.builder_inputs(dev, B)
        g, h, nn_idx = x["g"], x["h"], x["nn_idx"]
        _, M, K = nn_idx.shape
        N, D = g.shape[1], g.shape[2]
        rows = {name: lib.pcm_builder_fwd_partials(B, M, D) for name, lib in libs.items()}
        part = torch.empty((max(rows.values()), 2, D), dtype=torch.float32, device=dev)
        outs = [torch.empty((B, M, D), dtype=torch.bfloat16, device=dev) for _ in range(3)]
        bm = torch.empty((B, M, D), dtype=torch.int32, device=dev)
        totals = torch.empty((2, D), dtype=torch.float32, device=dev)

        def runner(lib):
            def run():
                err = lib.pcm_builder_fwd(g.data_ptr(), h.data_ptr(), nn_idx.data_ptr(),
                                          *[t.data_ptr() for t in outs], bm.data_ptr(),
                                          part.data_ptr(), totals.data_ptr(), B, N, M, K, D,
                                          dev.index, stream)
                if err:
                    raise RuntimeError(f"pcm_builder_fwd: CUDA error {err}")
            return run

        runner(libs["everything"])()
        ref = fb.builder_core_plain(g, h, nn_idx)
        exact = all(torch.equal(a, b) for a, b in zip((outs[0], outs[1], bm),
                                                       (ref[0], ref[1], ref[3])))
        print(f"B={B}: everything's vmax, vmin and bitmap equal to the plain version's: "
              f"{exact}; partial rows {rows}", flush=True)
        order = ["everything", *(name for name, _ in variants), "everything"]
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(chip_smoke.cuda_ms(runner(libs[name]), 20))
            order.reverse()
        for name, ts in times.items():
            print(f"  {name:13s} {min(ts):.4f}-{max(ts):.4f} ms", flush=True)
        del x, g, h, nn_idx, part, outs, bm, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
