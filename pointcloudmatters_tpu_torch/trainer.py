"""The training step (port of ``pointcloudmatters_tpu/trainer.py:237-277``):
forward, loss, backward, optimizer and schedule step, gradient norm and
batch statistics, on one device.

Precisions as the JAX trainer has them: ``"32-true"`` (or ``"32"``), and the
mixed ones (``"bf16-mixed"``, ``"16-mixed"``, ``"bf16"``, ``"16"``, all
bf16 compute). Mixed precision is a cast, not autocast: the step runs the
policy on bf16 copies of every floating parameter and batch array, keeps
the batch-norm running statistics f32, takes the loss in f32 and gets f32
gradients for the f32 master parameters, which the f32 optimizer updates
(``trainer.py:249-268``). Under autocast, LayerNorm, softmax and reductions
would stay f32 where JAX rounds to bf16, and elementwise ops would keep
whatever type reaches them. The step reads nothing back from the device:
metrics stay device tensors
(``module.train_metrics`` accumulates them there), the oneshot kernel's
dropout seeds come from a CPU generator, and the batch should already be on
the device (a host batch is copied, which waits for the device). DDP,
callbacks, checkpoints and validation come with later slices.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.utils.optimizer import clip_by_global_norm, global_norm

__all__ = ["Trainer"]

_MIXED = ("bf16-mixed", "16-mixed", "bf16", "16")


class Trainer:
    """Drives ``BCModule`` training steps.

    Args:
        precision: ``"32-true"``/``"32"`` or a mixed precision (bf16
            compute over f32 parameters).
        device: where the step runs (default: the module's device).
        seed: seeds the module's random streams (``BCModule.make_rngs``).
        gradient_clip_val: global-norm clip of the gradients, if set.
    """

    def __init__(self, precision: str = "32-true",
                 device: Union[str, torch.device, None] = None, seed: int = 0,
                 gradient_clip_val: float | None = None):
        precision = str(precision)
        if precision not in _MIXED + ("32-true", "32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.compute_dtype = torch.bfloat16 if precision in _MIXED else None
        self.device = None if device is None else torch.device(device)
        self.seed = seed
        self.gradient_clip_val = gradient_clip_val
        self.rngs: dict[str, torch.Generator] | None = None
        self.global_step = 0

    def setup(self, module: BCModule, total_steps: int) -> None:
        """Optimizer and schedule over ``total_steps``, and the step's random
        streams (the JAX ``setup_module`` + ``initial_state``)."""
        if self.device is not None and module.device != self.device:
            raise ValueError(f"module on {module.device}, trainer on {self.device}")
        module.configure_optimizers(total_steps, self.gradient_clip_val)
        self.rngs = module.make_rngs(self.seed)

    def train_step(self, module: BCModule, batch: dict) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; returns the step's metrics (loss,
        action_loss, kl_loss, grad_norm: 0-d tensors on the device). A
        module not set up yet is set up for a 1-step schedule, as the JAX
        module's ``initial_state`` does."""
        if module.optimizer is None or self.rngs is None:
            self.setup(module, total_steps=1)
        params = [p for p in module.policy.parameters() if p.requires_grad]
        module.optimizer.zero_grad(set_to_none=False)
        out = module.forward_train(batch, self.rngs, self.compute_dtype)
        out["loss"].to(torch.float32).backward()
        for p in params:
            # parameters off the path (the decoder's dead layers) get zero
            # gradients, as under jax.grad, so weight decay still reaches them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grad_norm = global_norm(grads)
        if module.gradient_clip_val:
            clip_by_global_norm(grads, module.gradient_clip_val, grad_norm)
        module.optimizer.step()
        if module.scheduler is not None:
            module.scheduler.step()
        self.global_step += 1
        metrics = {k: out[k].detach().to(torch.float32)
                   for k in module.train_metric_keys if k in out}
        metrics["grad_norm"] = grad_norm
        module.train_metrics.update(metrics)
        return metrics

    def fit_steps(self, module: BCModule, batches: Sequence[dict], n: int
                  ) -> list[dict[str, torch.Tensor]]:
        """``n`` steps over ``batches`` in turn; the metrics of each step."""
        if not batches:
            raise ValueError("fit_steps needs at least one batch")
        return [self.train_step(module, batches[i % len(batches)]) for i in range(n)]
