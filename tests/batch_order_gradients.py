#!/usr/bin/env python3
"""How a tiny ResNet's train-mode gradients depend on the order of the
batch, in the JAX package and in the port, on the CPU: the ResNet-18 of
``tests/test_torch_img_encoders.py`` (24-pixel images resized to 32, 8
images, JAX's randomised variables carried over by ``flax_to_torch``, the
gradients of ``sum(out * cot)`` with the batch norms in training).

    JAX_PLATFORMS=cpu python3 tests/batch_order_gradients.py [--seeds 8] [--f64-statistics]

For each channel count (1, 3, 4, 6) and image seed it prints, as the
largest |difference| / max(1, max|reference|) over the parameters:
JAX's gradients for the batch reversed against JAX's for it in its order,
the port's against each, and the smallest |input| of any ReLU in the
port's forward. Both packages sum a batch norm's statistics in f32, even
for f64 activations; with ``--f64-statistics`` everything runs in f64
(``jax_enable_x64``, ``torch.float64``) and the two packages' batch norms
sum in f64, patched in this process only (``tests/test_torch_img_encoders.py``'s
``f64_statistics``; the files stay as they are).
"""

from __future__ import annotations

import argparse
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8, help="image seeds 0..n-1")
    parser.add_argument("--f64-statistics", action="store_true",
                        help="f64 throughout, the batch norms summing in f64")
    args = parser.parse_args()

    import jax

    if args.f64_statistics:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet as port_resnet
    from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
    from test_torch_img_encoders import _images, backbones, f64_statistics, init_variables

    if args.f64_statistics:
        f64_statistics(setattr)
    dtype = np.float64 if args.f64_statistics else np.float32
    torch.set_num_threads(1)
    relu_inputs = []

    class _Recorded:
        """``torch.nn.functional`` for the port's ResNet, recording ReLU inputs."""

        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x):
            relu_inputs.append(x.detach().abs().min().item())
            return F.relu(x)

    port_resnet.F = _Recorded()
    print(f"{'ch':>2} {'seed':>4}  jax(reversed)/jax  port/jax  port/jax(reversed)  "
          "min |ReLU input|")
    for channels in (1, 3, 4, 6):
        jmod, tmod = backbones("resnet", channels)
        variables = init_variables(jmod, jnp.asarray(_images(channels, 8)))
        variables = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
        stats = variables["batch_stats"]
        shape = jax.eval_shape(lambda v, b: jmod.apply(v, b), variables,
                               jnp.asarray(_images(channels, 8).astype(dtype))).shape
        cot = np.random.RandomState(1).randn(*shape).astype(dtype)

        @jax.jit
        def grads(params, images, c):
            def loss(p):
                out, _ = jmod.apply({"params": p, "batch_stats": stats}, images, train=True,
                                    mutable=["batch_stats"])
                return jnp.sum(out * c)
            return jax.grad(loss)(params)

        tmod.load_state_dict(flax_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                        variables), tmod))
        tmod.to(torch.float64 if args.f64_statistics else torch.float32)

        def as_port(g):
            ref = flax_to_torch({"params": jax.tree.map(np.asarray, g), "batch_stats": stats},
                                tmod)
            return {n: ref[n].numpy() for n, _ in tmod.named_parameters()}

        def gap(got, ref):
            return max(np.abs(got[n] - ref[n]).max() / max(1.0, np.abs(ref[n]).max())
                       for n in ref)

        for seed in range(args.seeds):
            x = _images(channels, 8, seed).astype(dtype)
            given = as_port(grads(variables["params"], jnp.asarray(x), jnp.asarray(cot)))
            reversed_ = as_port(grads(variables["params"], jnp.asarray(x[::-1]),
                                      jnp.asarray(cot[::-1])))
            tmod.zero_grad()
            relu_inputs.clear()
            (tmod(torch.from_numpy(x), train=True) * torch.from_numpy(cot)).sum().backward()
            port = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
            print(f"{channels:>2} {seed:>4}  {gap(reversed_, given):17.2e}  "
                  f"{gap(port, given):8.2e}  {gap(port, reversed_):18.2e}  "
                  f"{min(relu_inputs):16.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
