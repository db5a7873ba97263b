"""pointcloudmatters_tpu_torch — PyTorch/CUDA port of ``pointcloudmatters_tpu``.

The JAX package beside it is the reference: each module here mirrors the
path of its JAX counterpart, and each Pallas kernel on a ported path is a
hand-written CUDA kernel for Hopper (``csrc/``, built by ``_build.py`` at
first use) with a plain PyTorch version beside it. A CPU tensor runs the
plain version; a CUDA tensor runs the kernel or raises.

Ported so far: ACT over point clouds (PointNet, SpUNet: ``entry.build_flagship``)
and over images (ResNet, ViT, MultiViT: ``entry.build_image_policy``) and the
Diffusion Policy over point clouds, served (``BCModule.predict``) and trained
(``trainer.Trainer``: the step in f32 and bf16, ``fit``, ``validate``,
checkpoints, data parallelism), their data pipelines, and the entry points
``python -m pointcloudmatters_tpu_torch.train`` and ``.validate``, which
compose the repository's ``configs/``. This package
imports neither jax nor flax, nor anything of the JAX package.
"""

import torch

# Full f32 everywhere on the port's path: TF32 matmuls and convolutions keep
# about three decimal digits, which re-ranks nearest neighbours and moves
# attention outputs past the parity tolerances (the JAX package forces full
# f32 for distances for the same reason, ops/pointops.py:90-97).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
