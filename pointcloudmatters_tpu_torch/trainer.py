"""The trainer (port of ``pointcloudmatters_tpu/trainer.py``): the training
step, the epoch loop ``fit`` with gradient accumulation and held-out
validation, ``validate``, and checkpoints, on one device or data-parallel
over several, one process a device.

Precisions as the JAX trainer has them: ``"32-true"`` (or ``"32"``), and the
mixed ones (``"bf16-mixed"``, ``"16-mixed"``, ``"bf16"``, ``"16"``, all
bf16 compute). Mixed precision is a cast, not autocast: the step runs the
policy on bf16 copies of every floating parameter and batch array, keeps
the batch-norm running statistics f32, takes the loss in f32 and gets f32
gradients for the f32 master parameters, which the f32 optimizer updates
(``trainer.py:249-268``). Under autocast, LayerNorm, softmax and reductions
would stay f32 where JAX rounds to bf16, and elementwise ops would keep
whatever type reaches them.

With ``accumulate_grad_batches`` k > 1 a step is a micro-step, as under the
JAX module's ``optax.MultiSteps``: every micro-step runs forward and
backward, updates the batch statistics and the train metrics, takes its own
``grad_norm`` and folds its gradients into an f32 running mean; every k-th
clips the mean and steps the optimizer and the schedule, and the others
leave the parameters bit-equal. The schedule counts optimizer steps.

The step reads nothing back from the device: metrics stay device tensors,
the oneshot kernel's dropout seeds come from a CPU generator, and ``fit``
copies each batch to the card from page-locked memory without blocking.
``fit`` reads values back only where the JAX trainer reads floats: every
``log_every_n_steps`` micro-steps, every step under ``detect_anomaly``, and
at the end of an epoch. ``accelerator="cpu"`` trains on the CPU; ``"auto"``,
``"gpu"``, ``"cuda"`` and ``"tpu"`` (the shipped configs' word) on the card,
and raise without one. ``fit`` calls the hooks of its callbacks
(``pointcloudmatters_tpu_torch/callbacks.py``), the first of which with a
``best_model_path`` is ``checkpoint_callback``.

A checkpoint is a directory at the path the JAX trainer's Orbax checkpoint
would take, holding one ``torch.save`` file (:data:`CHECKPOINT_FILE`) of the
JAX checkpoint's keys: ``params`` (the f32 masters), ``batch_stats`` (the
running statistics), ``step`` and ``epoch``; unless ``weights_only``,
``opt_state`` (the optimizer's, the schedule's and the gradient mean's
state) and ``rng`` (the state of each of the step's generators); and
``extras`` when the module has any. ``fit(ckpt_path=)`` restores after the
optimizer is built and ``validate(ckpt_path=)`` before validating, as in
JAX. ``profiler`` (``simple``, ``advanced``, ``pytorch``, ``torch`` or
true) runs ``fit``'s loop under ``torch.profiler`` and writes the trace
into ``<default_root_dir>/torch_trace`` (``utils/profiling.py``); another
value raises ``ValueError``.

Data parallelism (the JAX trainer's ``"data"`` mesh, ``trainer.py:6-12``),
one process a device joined by ``torch.distributed``
(:mod:`pointcloudmatters_tpu_torch.utils.dist`): a step at world size W
over W local batches computes what a step at world size 1 computes over
their concatenation, as the JAX step over a sharded global batch does.
``fit`` and ``validate`` use the default process group when one is
initialised (so a caller picks the backend: ``chip_smoke.py`` and the tests
run gloo over CUDA tensors), else join the one torchrun's or SLURM's
variables describe (NCCL on the card ``LOCAL_RANK`` names, gloo on the
CPU); ``python -m pointcloudmatters_tpu_torch.train`` starts the processes
itself. ``devices`` asking for more than one process where none was started
raises, as does asking for more cards than the machine has. In a group:

- parameters and running statistics start as rank 0's (one broadcast);
- each micro-step sums its gradients, its loss metrics and its rows over
  the ranks in one flat buffer and divides by W, so that ``grad_norm``, the
  clip, the gradient mean and the logged losses are the global batch's;
  the ranks' local batches must be equal (a device-side check), since the
  loss of each is a mean over it;
- the batch norms sum their statistics over the ranks (``nn_utils.py``),
  and the step's random streams are split into those shared by every rank
  and each rank's own (``BCModule.make_rngs``);
- metrics reduce over the ranks at ``compute`` (``utils/metrics.py``);
  ``samples_per_sec`` counts the global batch;
- ``should_stop`` is rank 0's; checkpoints and log files are written by
  rank 0 alone, and every rank restores from them.
"""

from __future__ import annotations

import math
import os
import time
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import torch

from pointcloudmatters_tpu_torch.models.bc_module import BCModule, select_model_batch, to_device
from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.loggers import as_multi_logger
from pointcloudmatters_tpu_torch.utils.optimizer import clip_by_global_norm, global_norm
from pointcloudmatters_tpu_torch.utils.profiling import make_profiler
from pointcloudmatters_tpu_torch.utils.pylogger import RankedLogger

__all__ = ["Trainer", "CHECKPOINT_FILE", "write_checkpoint", "read_checkpoint"]

CHECKPOINT_FILE = "checkpoint.pt"

log = RankedLogger(__name__, rank_zero_only=True)

_MIXED = ("bf16-mixed", "16-mixed", "bf16", "16")
_ON_CARD = ("auto", "gpu", "cuda", "tpu")


def _limit(n_batches: int, limit) -> int:
    """Batches to run of ``n_batches``: all for None, a share for a float
    (at least 1 unless the share is 0), at most ``limit`` for an int."""
    if limit is None:
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit)) if limit > 0 else 0
    return min(n_batches, int(limit))


def _batch_size_of(batch) -> int:
    """The leading size of the batch's first array of rank >= 1, in the
    sorted key order of the JAX trainer's ``jax.tree.leaves``."""
    if isinstance(batch, Mapping):
        for key in sorted(batch):
            n = _batch_size_of(batch[key])
            if n:
                return n
        return 0
    if isinstance(batch, (list, tuple)):
        return next((n for n in map(_batch_size_of, batch) if n), 0)
    shape = getattr(batch, "shape", ())
    return int(shape[0]) if len(shape) >= 1 else 0


def write_checkpoint(path: str, item: dict) -> None:
    """Write a checkpoint dict into the directory ``path`` (made if absent;
    a checkpoint already there is replaced whole)."""
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, CHECKPOINT_FILE)
    torch.save(item, file + ".tmp")
    os.replace(file + ".tmp", file)


def read_checkpoint(path: str) -> dict:
    """The checkpoint dict in the directory ``path``, its tensors on the
    CPU."""
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)


class Trainer:
    """Trains and validates a ``BCModule``; takes the JAX trainer's keys
    (``configs/trainer/*.yaml``), of which ``strategy``, ``sync_batchnorm``
    (batch statistics are global, as under GSPMD), ``deterministic`` and
    ``overfit_batches`` are accepted and, as there, unused. ``seed``, when
    given, becomes the module's ``seed``, which seeds its random streams
    (``BCModule.make_rngs``)."""

    def __init__(
        self,
        default_root_dir: str = ".",
        min_epochs: int = 1,
        max_epochs: int = 10,
        accelerator: str = "auto",
        devices: Any = "auto",
        check_val_every_n_epoch: int = 1,
        precision: str = "32-true",
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        deterministic: bool = False,
        detect_anomaly: bool = False,
        limit_train_batches: Any = 1.0,
        limit_val_batches: Any = 1.0,
        log_every_n_steps: int = 50,
        num_sanity_val_steps: int = 0,
        callbacks: Any = None,
        logger: Any = None,
        strategy: str = "data_parallel",
        num_nodes: int = 1,
        sync_batchnorm: bool = True,
        profiler: Optional[str] = None,
        fast_dev_run: bool = False,
        overfit_batches: float = 0.0,
        seed: Optional[int] = None,
        **_ignored,
    ):
        precision = str(precision)
        if precision not in _MIXED + ("32-true", "32"):
            raise ValueError(f"unknown precision {precision!r}")
        if accelerator not in _ON_CARD + ("cpu",):
            raise ValueError(f"unknown accelerator {accelerator!r}")
        self.default_root_dir = os.path.abspath(default_root_dir)
        os.makedirs(self.default_root_dir, exist_ok=True)
        self.profiler = make_profiler(profiler, self.default_root_dir)
        self.min_epochs = min_epochs or 1
        self.fast_dev_run = fast_dev_run
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.accelerator = accelerator
        self.devices_spec = devices
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.precision = precision
        self.compute_dtype = torch.bfloat16 if precision in _MIXED else None
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.deterministic = deterministic
        self.detect_anomaly = detect_anomaly
        self.limit_train_batches = 1 if fast_dev_run else limit_train_batches
        self.limit_val_batches = 1 if fast_dev_run else limit_val_batches
        self.log_every_n_steps = log_every_n_steps
        self.num_sanity_val_steps = num_sanity_val_steps
        if callbacks is None:
            callbacks = []
        elif isinstance(callbacks, dict):
            callbacks = [cb for cb in callbacks.values() if cb is not None]
        self.callbacks = list(callbacks)
        self.logger = as_multi_logger(logger)
        self.strategy = strategy
        self.num_nodes = num_nodes
        self.sync_batchnorm = sync_batchnorm
        self.overfit_batches = overfit_batches
        self.seed = seed

        self.rngs: dict[str, torch.Generator] | None = None
        self.global_step = 0
        self.current_epoch = 0
        self.should_stop = False
        self.estimated_stepping_batches: Optional[int] = None
        self.checkpoint_callback = next(
            (cb for cb in self.callbacks if hasattr(cb, "best_model_path")), None)
        self._schedule = None
        self._fit_first_step = 0
        self._module: Optional[BCModule] = None
        self.datamodule = None

    # ------------------------------------------------------------------
    # device and steps
    # ------------------------------------------------------------------
    def select_device(self) -> torch.device:
        """The CPU for ``accelerator="cpu"``, else the card ``LOCAL_RANK``
        names (0 when unset); raises where there is no card, and where
        ``devices`` asks for more cards than there are."""
        if self.accelerator == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(f"accelerator={self.accelerator!r} trains on a CUDA device and "
                               f"there is none; pass accelerator='cpu' to train on the CPU")
        dist.requested_world(self.accelerator, self.devices_spec)
        return torch.device("cuda", dist.local_rank())

    def setup(self, module: BCModule, total_steps: int) -> None:
        """Optimizer, schedule and gradient accumulation over
        ``total_steps`` optimizer steps, and the step's random streams (the
        JAX ``setup_module`` + ``initial_state``); ``module`` becomes the one
        this trainer checkpoints. In a process group the module's
        parameters and running statistics become rank 0's."""
        self._module = module
        if dist.is_initialized():
            dist.broadcast_(list(module.policy.state_dict().values()))
        module.configure_optimizers(total_steps, self.gradient_clip_val,
                                    self.accumulate_grad_batches)
        if self.seed is not None:
            module.seed = self.seed
        self.rngs = module.make_rngs(module.seed, dist.get_rank(), dist.get_world_size())

    def train_step(self, module: BCModule, batch: dict) -> dict[str, torch.Tensor]:
        """One micro-step on ``batch`` (an optimizer step when gradients are
        not accumulated); updates ``module.train_metrics`` and returns the
        step's metrics (the module's ``train_metric_keys``, ACT's loss,
        action_loss and kl_loss or the Diffusion Policy's loss, and
        grad_norm: 0-d tensors on the device). A module not set up yet is
        set up for a 1-step schedule, as the JAX module's ``initial_state``
        does."""
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
        metrics = {k: out[k].detach().to(torch.float32)
                   for k in module.train_metric_keys if k in out}
        if dist.is_initialized():
            metrics = self._all_reduce_step(grads, metrics, _batch_size_of(batch))
        grad_norm = global_norm(grads)  # this micro-batch's, as JAX logs it
        mean = module.gradient_mean
        if mean is None or mean.update(grads):
            if module.gradient_clip_val:
                clip_by_global_norm(grads, module.gradient_clip_val,
                                    grad_norm if mean is None else global_norm(grads))
            module.optimizer.step()
            if module.scheduler is not None:
                module.scheduler.step()
        self.global_step += 1
        metrics["grad_norm"] = grad_norm
        module.train_metrics.update(metrics, 1.0 / dist.get_world_size())
        return metrics

    @staticmethod
    def _all_reduce_step(grads: list, metrics: dict, rows: int) -> dict:
        """The gradients (in place) and metrics of the global batch: each
        summed over the ranks in one flat buffer, with the ranks' rows, and
        divided by W. The mean of the ranks' mean losses is the global
        mean only over equal local batches: a device-side check raises
        otherwise (at the next synchronisation, on the card)."""
        world = dist.get_world_size()
        device = grads[0].device
        values = list(metrics.values())
        flat = torch.cat([g.reshape(-1) for g in grads] + [v.reshape(1) for v in values]
                         + [torch.full((1,), float(rows), device=device)])
        dist.all_reduce_([flat])
        torch._assert_async(flat[-1] == float(rows * world),
                            "the ranks' local batches differ in size")
        flat.div_(world)
        n = sum(g.numel() for g in grads)
        for g, part in zip(grads, flat[:n].split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        return dict(zip(metrics, flat[n:n + len(values)]))

    def fit_steps(self, module: BCModule, batches: Sequence[dict], n: int
                  ) -> list[dict[str, torch.Tensor]]:
        """``n`` steps over ``batches`` in turn; the metrics of each step."""
        if not batches:
            raise ValueError("fit_steps needs at least one batch")
        return [self.train_step(module, batches[i % len(batches)]) for i in range(n)]

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, weights_only: bool = False) -> None:
        """Save the module's state into the directory ``path`` (module doc);
        ``weights_only`` leaves out ``opt_state`` and ``rng``. In a process
        group rank 0 writes, and every rank returns once it has."""
        if dist.is_main_process():
            self._write_checkpoint(os.path.abspath(path), weights_only)
        dist.barrier()

    def _write_checkpoint(self, path: str, weights_only: bool) -> None:
        module = self._module
        params = dict(module.policy.named_parameters())
        state = module.policy.state_dict()
        item = {
            "params": {k: v.detach() for k, v in params.items()},
            "batch_stats": {k: v for k, v in state.items() if k not in params},
            "step": self.global_step - self._fit_first_step,
            "epoch": self.current_epoch,
        }
        if not weights_only:
            mean = module.gradient_mean
            item["opt_state"] = {
                "optimizer": module.optimizer.state_dict(),
                "scheduler": None if module.scheduler is None else module.scheduler.state_dict(),
                "gradient_mean": None if mean is None else mean.state_dict(),
            }
            item["rng"] = {k: g.get_state() for k, g in self.rngs.items()}
        extras = module.state_dict_extras()
        if extras:
            item["extras"] = extras
        write_checkpoint(path, item)

    def restore_checkpoint(self, path: str, module: Optional[BCModule] = None) -> dict:
        """Load the checkpoint in ``path`` into ``module`` (by default the
        one ``fit`` or ``validate`` holds) and this trainer; set
        ``current_epoch`` to the saved epoch + 1 and ``global_step`` to the
        saved step. A module without an optimizer gets one first (a 1-step
        schedule, as the JAX module's ``initial_state`` builds). Returns the
        checkpoint dict. In a process group every rank reads the file; the
        streams shared by the ranks continue from it, and each rank's own
        start anew from ``(seed, rank, step)`` (the file holds rank 0's)."""
        module = self._module = module or self._module
        path = os.path.abspath(path)
        ckpt = read_checkpoint(path)
        module.policy.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]}, strict=True)
        if module.optimizer is None or self.rngs is None:
            self.setup(module, self.estimated_stepping_batches or 1)
        if "opt_state" in ckpt:
            opt_state = ckpt["opt_state"]
            module.optimizer.load_state_dict(opt_state["optimizer"])
            if (opt_state["scheduler"] is None) != (module.scheduler is None):
                raise ValueError("the checkpoint and the module disagree on a learning-rate "
                                 "schedule")
            if module.scheduler is not None:
                module.scheduler.load_state_dict(opt_state["scheduler"])
            mean = module.gradient_mean
            if (opt_state["gradient_mean"] is None) != (mean is None):
                raise ValueError("the checkpoint and the trainer disagree on gradient "
                                 "accumulation (accumulate_grad_batches)")
            if mean is not None:
                mean.load_state_dict(opt_state["gradient_mean"], module.device)
        if "rng" in ckpt:
            world = dist.get_world_size()
            for name in module.train_rng_streams:  # "bits" is "dropout" in a world of one
                if name in ckpt["rng"] and (world == 1 or name not in module.rank_rng_streams):
                    self.rngs[name].set_state(ckpt["rng"][name])
            if world > 1:
                fresh = module.make_rngs(module.seed, dist.get_rank(), world, int(ckpt["step"]))
                self.rngs.update({name: fresh[name] for name in module.rank_rng_streams})
        self.current_epoch = int(ckpt["epoch"]) + 1
        self.global_step = int(ckpt["step"])
        self._fit_first_step = 0
        if "extras" in ckpt:
            module.load_state_dict_extras(ckpt["extras"])
        log.info(f"Restored checkpoint from {path} (epoch {self.current_epoch})")
        return ckpt

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def log_metrics(self, metrics: dict) -> None:
        if metrics:
            self.logger.log_metrics(metrics, self.global_step)

    def current_lr(self) -> Optional[float]:
        """The learning rate that the JAX trainer logs (ROADMAP.md §3, kept
        by design): the schedule the module held when ``fit`` began (none
        in a module's first fit: JAX reads it before it builds the
        optimizer) at the micro-steps of this fit (JAX's ``state.step``),
        which under accumulation is not the rate the optimizer applied."""
        if self._schedule is None:
            return None
        return self._schedule.lr_at(self.global_step - self._fit_first_step)

    # ------------------------------------------------------------------
    # fit and validate
    # ------------------------------------------------------------------
    def _device(self) -> torch.device:
        """The device ``fit`` and ``validate`` run on, after joining the
        process group the environment describes unless one is initialised
        (before a loader counts its batches, which depend on the group).
        Raises where ``devices`` and ``num_nodes`` ask for more than one
        process and this one is alone."""
        device = self.select_device()
        world = dist.init_dist(device.type)
        wanted = dist.requested_world(self.accelerator, self.devices_spec, self.num_nodes)
        if world == 1 and wanted > 1:
            raise ValueError(
                f"devices={self.devices_spec!r}, num_nodes={self.num_nodes} ask for {wanted} "
                "processes, one a device, and this one runs alone: start them with "
                "python -m pointcloudmatters_tpu_torch.train, torchrun or srun")
        return device

    def _start(self, model: BCModule, datamodule, loader, device: torch.device) -> None:
        """What ``fit`` and ``validate`` do before their loops: the device,
        the JAX trainer's example batch and the module's ``setup_module``."""
        model.to(device)
        self._module = model
        self.datamodule = datamodule
        # The JAX trainer draws one batch here to initialise the parameters.
        # The port's policy is built already, but the draw stays: it starts
        # the loader's epoch 0 (so epoch 0 shuffles with seed + 1) and takes
        # its samples' random start steps, grid picks and shuffles from
        # numpy's global stream. Without it every later batch would differ
        # from the reference's.
        batches = iter(loader)
        try:
            next(batches)
        except StopIteration:
            raise RuntimeError(
                "the dataloader yielded no batches: the dataset has fewer samples than "
                "batch_size (drop_last drops the remainder); lower the batch size or add "
                "data") from None
        finally:
            batches.close()
        model.setup_module(self)

    def fit(self, model: BCModule, datamodule=None, ckpt_path: Optional[str] = None) -> None:
        device = self._device()
        if hasattr(datamodule, "setup"):
            datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        n_train = _limit(len(train_loader), self.limit_train_batches)
        opt_steps_per_epoch = max(1, n_train // self.accumulate_grad_batches)
        self.estimated_stepping_batches = opt_steps_per_epoch * self.max_epochs
        self._start(model, datamodule, train_loader, device)
        self._schedule, self._fit_first_step = model.scheduler, self.global_step
        self.setup(model, self.estimated_stepping_batches)
        if ckpt_path:
            self.restore_checkpoint(ckpt_path)

        for cb in self.callbacks:
            cb.setup(self, model)
        for cb in self.callbacks:
            cb.on_fit_start(self, model)
        t_fit = time.time()
        log.info(f"fit: {model.device} x {dist.get_world_size()} processes, {n_train} "
                 f"batches/epoch, {self.estimated_stepping_batches} optimizer steps total, "
                 f"precision={self.precision}")

        # the sanity check: N validation batches before the first epoch, so
        # that a broken validation path fails at once; their metrics are
        # discarded and the trackers reset, so that they seed no best value
        if (self.num_sanity_val_steps and not self.fast_dev_run
                and self.limit_val_batches not in (0, 0.0)):
            n = int(self.num_sanity_val_steps)
            saved = self.limit_val_batches
            if n != -1:
                self.limit_val_batches = min(n, int(saved)) if isinstance(saved, int) else n
            log.info("sanity-checking the validation loop "
                     f"({'all' if n == -1 else self.limit_val_batches} batches)")
            try:
                model.run_validation(self, datamodule)
            finally:
                self.limit_val_batches = saved
                model.val_metrics.reset()
                model.best_val_metrics.reset()

        if self.profiler is not None:
            self.profiler.start()
        try:
            for epoch in range(self.current_epoch, self.max_epochs):
                self.current_epoch = epoch
                epoch_metrics = self._train_epoch(model, train_loader, n_train)
                self.log_metrics(epoch_metrics)

                val_metrics: dict = {}
                if (self.check_val_every_n_epoch
                        and (epoch + 1) % self.check_val_every_n_epoch == 0
                        and self.limit_val_batches not in (0, 0.0)):
                    val_metrics = model.run_validation(self, datamodule)
                    self.log_metrics(val_metrics)
                    for cb in self.callbacks:
                        cb.on_validation_end(self, model, val_metrics, epoch)
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self, model, {**epoch_metrics, **val_metrics}, epoch)
                self.should_stop = dist.broadcast_flag(self.should_stop)
                if self.should_stop and epoch + 1 >= self.min_epochs:
                    log.info(f"early stop at epoch {epoch}")
                    break
        finally:
            if self.profiler is not None:
                self.profiler.stop()

        for cb in self.callbacks:
            cb.on_fit_end(self, model)
        self.logger.finalize()
        log.info(f"fit done in {time.time() - t_fit:.1f}s ({self.global_step} steps)")

    def _train_epoch(self, model: BCModule, loader, n_train: int) -> dict:
        """One epoch of micro-steps; the epoch's train metrics and
        ``samples_per_sec`` (of the global batch), as floats."""
        model.train_metrics.reset()
        t0, seen = time.time(), 0
        for i, batch in enumerate(loader):
            if i >= n_train:
                break
            seen += _batch_size_of(batch)
            metrics = self.train_step(
                model, to_device(select_model_batch(batch), model.device, non_blocking=True))
            if self.detect_anomaly:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {self.global_step}")
            if self.global_step % self.log_every_n_steps == 0:
                host = {k: float(v) for k, v in metrics.items()}
                lr = self.current_lr()
                if lr is not None:
                    host["lr"] = lr
                self.log_metrics(host)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        epoch_metrics = {k: float(v) for k, v in model.train_metrics.compute().items()}
        if seen:
            epoch_metrics["samples_per_sec"] = seen * dist.get_world_size() / (time.time() - t0)
        return epoch_metrics

    def validate(self, model: BCModule, datamodule=None,
                 ckpt_path: Optional[str] = None) -> dict:
        """Held-out validation of ``model`` as it is, or as the checkpoint
        ``ckpt_path`` holds it (the JAX trainer's ``validate``); the
        metrics, logged."""
        device = self._device()
        if hasattr(datamodule, "setup"):
            datamodule.setup("validate")
        loader = None
        for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
            fn = getattr(datamodule, name, None)
            if fn is None:
                continue
            try:  # a validation-only datamodule may have no train split
                candidate = fn()
            except Exception:
                continue
            if candidate is not None:
                loader = candidate
                break
        if loader is None:
            raise RuntimeError("validate() needs at least one dataloader (train, val, or test)")
        self._start(model, datamodule, loader, device)
        if ckpt_path:
            self.restore_checkpoint(ckpt_path)
        metrics = model.run_validation(self, datamodule)
        self.log_metrics(metrics)
        self.logger.finalize()
        return metrics
