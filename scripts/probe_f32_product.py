#!/usr/bin/env python3
"""Time the S = Q K^T product of the f32 attention kernels three ways on one GPU.

    python3 scripts/probe_f32_product.py

Builds ``scripts/probe_f32_product.cu`` with nvcc (sm_90a) and runs each of its
schemes on q, k of (B H, L, dh) f32 drawn from a seeded normal, q scaled by
dh^-0.5 as the kernels scale it: 3xTF32 on the tensor cores
(``csrc/f32_mma.cuh``), TF32 alone, and the FP32 pipes (8 x 8 outputs a
thread, K-major ``float4`` tiles). Each computes S over every (query, key)
pair and keeps the row max, which it writes. Prints, per scheme and shape,
the CUDA-event time over 20 launches after a warm-up, the achieved f32
TFLOP/s (2 B H L^2 dh flops), and the worst error of the scores of
(batch, head) 0 and of the row maxima against an f64 product, beside the
error of PyTorch's own f32 product (TF32 off) of the same inputs. Then lists
the kernels that one forward and backward of PyTorch's f32
``scaled_dot_product_attention`` launch (the library yardstick of
``chip_smoke.py``). Needs the card and the CUDA toolkit; prints the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMES = {0: "3xtf32", 1: "tf32", 2: "fp32_pipes"}
SHAPES = ((4, 8, 2051, 64), (4, 4, 2051, 128))  # B, H, L, dh


def build() -> ctypes.CDLL:
    sys.path.insert(0, REPO)
    from pointcloudmatters_tpu_torch import _build

    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "probe_f32_product.so")
    src = os.path.join(REPO, "scripts", "probe_f32_product.cu")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for probe_f32_product.cu")
    dll = ctypes.CDLL(lib)
    dll.probe_rowmax.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p)
    dll.probe_rowmax.restype = ctypes.c_int
    return dll


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_f32_product: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    dll = build()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    for B, H, L, dh in SHAPES:
        q = torch.from_numpy(rng.randn(B * H, L, dh).astype(np.float32) * dh ** -0.5).to(dev)
        k = torch.from_numpy(rng.randn(B * H, L, dh).astype(np.float32)).to(dev)
        ref = q[0].double() @ k[0].double().T
        ref_max = torch.stack([(q[i].double() @ k[i].double().T).amax(-1) for i in range(B * H)])
        torch_err = (q[0] @ k[0].T - ref).abs().max().item()
        flops = 2.0 * B * H * L * L * dh
        for scheme, name in SCHEMES.items():
            mx = torch.empty((B * H, L), device=dev)
            s = torch.empty((L, L), device=dev)

            def run(s_out=0):
                err = dll.probe_rowmax(scheme, q.data_ptr(), k.data_ptr(), B * H, L, dh,
                                       mx.data_ptr(), s_out, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err} at launch")

            run(s.data_ptr())
            torch.cuda.synchronize()
            s_err = (s.double() - ref).abs().max().item()
            max_err = (mx.double() - ref_max).abs().max().item()
            ms = chip_smoke.cuda_ms(run, 20)
            print(json.dumps(dict(
                scheme=name, B=B, H=H, L=L, dh=dh, ms=ms, tflops=flops / ms / 1e9,
                s_max_abs_err=s_err, rowmax_max_abs_err=max_err,
                torch_f32_s_max_abs_err=torch_err, max_abs_s=ref.abs().max().item())),
                flush=True)

    # the library's own f32 attention: the kernels one forward and backward of
    # scaled_dot_product_attention launch, by name
    from torch.nn.functional import scaled_dot_product_attention
    from torch.profiler import ProfilerActivity, profile

    B, H, L, dh = SHAPES[0]
    qkv = [torch.randn(B, H, L, dh, device=dev, requires_grad=True) for _ in range(3)]
    scaled_dot_product_attention(*qkv).sum().backward()  # warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scaled_dot_product_attention(*qkv).sum().backward()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0})
    print(json.dumps({"library_kernels": names}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
