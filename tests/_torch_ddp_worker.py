"""Rank processes of ``tests/test_torch_ddp.py``: jobs that run the port at
world size 1 (in the test's own process, no group) or W (one spawned process
a rank, gloo on the CPU, joined by a ``file://`` store); each returns what
the test compares. Imports torch and the port only, as a rank on the card
would.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointcloudmatters_tpu_torch import entry
from pointcloudmatters_tpu_torch.callbacks import Callback, EarlyStopping, ModelCheckpoint
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils
from pointcloudmatters_tpu_torch.models.components.act import act
from pointcloudmatters_tpu_torch.ops.attention import draw_seed
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.loggers import CSVLogger

# the tiny flagship of tests/test_sharding.py, dropout 0
DIMS = dict(hidden_dim=32, npoints=16, nsample=4, chunk=6, enc_layers=1, dec_layers=1,
            ffn=16)
OPT = {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05}
SCHED = {"scheduler": {"type": "OneCycleLR", "max_lr": 1e-3, "pct_start": 0.1,
                       "anneal_strategy": "cos", "div_factor": 100.0,
                       "final_div_factor": 1000.0}}
TOTAL_STEPS = 30
LATENT = 32  # the CVAE latent's width


def rows(tree, rank: int, world: int):
    """Rank ``rank``'s contiguous block of every array's leading axis."""
    if isinstance(tree, dict):
        return {k: rows(v, rank, world) for k, v in tree.items()}
    n = tree.shape[0] // world
    return tree[rank * n:(rank + 1) * n]


def row(tree, i: int):
    if isinstance(tree, dict):
        return {k: row(v, i) for k, v in tree.items()}
    return tree[i]


class fixed_eps:
    """The CVAE posterior's noise taken from ``eps`` (rows of one global
    draw) inside, as ``act.reparametrize``."""

    def __init__(self, eps: np.ndarray):
        self.eps = torch.from_numpy(eps)

    def __enter__(self):
        self.saved = act.reparametrize
        act.reparametrize = lambda mu, logvar, gen: mu + torch.exp(0.5 * logvar) * self.eps

    def __exit__(self, *exc):
        act.reparametrize = self.saved


def flagship(state_file: str, optimizer: dict = OPT) -> BCModule:
    policy = entry.build_flagship(**DIMS, dropout=0.0, device="cpu")
    policy.load_state_dict(torch.load(state_file, weights_only=True))
    return BCModule(policy, optimizer=optimizer, lr_scheduler=SCHED)


def _state(module: BCModule) -> dict:
    return {k: v.detach().clone() for k, v in module.policy.state_dict().items()}


def steps(rank: int, world: int, state_file: str, batches: list, eps: list,
          accumulate: int = 1, optimizer: dict = OPT) -> dict:
    """``len(batches)`` micro-steps over this rank's rows of each global
    batch, with ``eps`` rows: each step's metrics, the first step's
    gradients, the end state, and whether every odd micro-step left the
    parameters bit-equal."""
    module = flagship(state_file, optimizer)
    trainer = Trainer(precision="32-true", seed=0, accumulate_grad_batches=accumulate)
    trainer.setup(module, TOTAL_STEPS)
    out = {"metrics": [], "held": True}
    for i, (batch, e) in enumerate(zip(batches, eps)):
        before = _state(module)
        with fixed_eps(rows(e, rank, world)):
            metrics = trainer.train_step(module, rows(batch, rank, world))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in module.policy.named_parameters()}
        if accumulate > 1 and (i + 1) % accumulate:
            out["held"] &= all(torch.equal(before[k], v) for k, v in _state(module).items()
                               if not k.endswith((".mean", ".var")))
    out["state"] = _state(module)
    out["epoch_metrics"] = {k: float(v) for k, v in module.train_metrics.compute().items()}
    return out


def unequal(rank: int, world: int, state_file: str, batch: dict, eps: np.ndarray) -> dict:
    """A step whose ranks hold local batches of different sizes (rank r
    the first r + 1 rows): the error it raises."""
    module = flagship(state_file)
    trainer = Trainer(precision="32-true", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    with fixed_eps(eps[:rank + 1]):
        try:
            trainer.train_step(module, rows(batch, 0, batch["qpos"].shape[0] // (rank + 1)))
        except RuntimeError as e:
            return {"error": str(e)}
    return {"error": None}


def batch_norms(rank: int, world: int, arrays: dict) -> dict:
    """``MaskedBatchNorm`` and ``GroupedBNReluMax`` (both routes) in train
    mode over this rank's rows, backward of sum(y * cot): outputs, input
    and parameter gradients (the parameters' this rank's share), running
    statistics."""
    t = {k: torch.from_numpy(v) for k, v in rows(arrays["rows"], rank, world).items()}
    params = {k: torch.from_numpy(v) for k, v in arrays["params"].items()}
    out = {}

    def case(name, module, args, kwargs, grads):
        module.load_state_dict({k[len(name) + 1:]: v for k, v in params.items()
                                if k.startswith(name + ".")})
        y = module(*args, use_running_average=False, **kwargs)
        (y * t["cot" if name != "masked" else "x_cot"]).sum().backward()
        out[name] = {"y": y.detach(), "mean": module.mean.clone(), "var": module.var.clone(),
                     "dscale": module.scale.grad.clone(), "dbias": module.bias.grad.clone(),
                     **{k: x.grad.clone() for k, x in grads.items()}}

    x = t["x"].requires_grad_()
    case("masked", nn_utils.MaskedBatchNorm(16, momentum=0.01, eps=1e-3), (x,),
         {"mask": t["mask"]}, {"dx": x})
    g, h = t["g"].requires_grad_(), t["h"].requires_grad_()
    case("xla", nn_utils.GroupedBNReluMax(12), (g, h, t["nn_idx"]), {"impl": "xla"},
         {"dg": g, "dh": h})
    W = params["W"].clone().requires_grad_()
    h = t["h"].detach().clone().requires_grad_()
    case("fused_data", nn_utils.GroupedBNReluMax(12), (None, h, t["nn_idx"]),
         {"impl": "fused_data", "src": t["src"], "W": W}, {"dh": h, "dW": W})
    return out


def streams(rank: int, world: int, state_file: str) -> dict:
    """Draws from each of the step's streams, twice from ``(seed, rank)``."""
    module = flagship(state_file)
    draws = []
    for _ in range(2):
        rngs = module.make_rngs(3, rank, world)
        draws.append({
            "dropout": torch.rand((6, 6), generator=rngs["dropout"]),
            "seed": draw_seed(rngs["seed"]),
            "bits": torch.randint(0, 256, (64,), generator=rngs["bits"], dtype=torch.uint8),
            "vae": torch.randn(8, generator=rngs["vae"]),
            "bits_is_dropout": rngs["bits"] is rngs["dropout"],
        })
    return {"draws": draws}


class Samples:
    """The rows of a numpy batch as samples (every cloud at one width)."""

    def __init__(self, batch: dict):
        self.batch = batch

    def __len__(self):
        return len(self.batch["qpos"])

    def __getitem__(self, i):
        return row(self.batch, i)


class Record(Callback):
    def __init__(self):
        self.val, self.epochs = [], []

    def on_validation_end(self, trainer, module, metrics, epoch):
        self.val.append(metrics.get("val/loss"))

    def on_train_epoch_end(self, trainer, module, metrics, epoch):
        self.epochs.append((epoch, trainer.global_step, metrics.get("train/loss"),
                            metrics.get("samples_per_sec", 0.0) > 0))


def fit(rank: int, world: int, state_file: str, out_dir: str, train: dict, val: dict,
        eps: float = 0.5) -> dict:
    """``Trainer.fit`` over ``train`` (global batches of 4, shuffled) for
    up to 3 epochs, validating on ``val`` (global batches of 2) after each,
    with rank 0 alone holding an ``EarlyStopping`` that stops after the
    second; ``last`` and top-1 checkpoints and CSV logs under this rank's
    directories; then a resume from rank 0's ``last`` for one more epoch."""
    def run(max_epochs, ckpt_path=None, early=False):
        module = flagship(state_file)
        record = Record()
        callbacks = [record, ModelCheckpoint(dirpath=os.path.join(out_dir, f"ckpt_{rank}"),
                                             monitor="val/loss", save_last=True)]
        if early and rank == 0:
            callbacks.append(EarlyStopping("val/loss", min_delta=1e9, patience=1))
        trainer = Trainer(default_root_dir=os.path.join(out_dir, f"root_{rank}"),
                          accelerator="cpu", devices=world, max_epochs=max_epochs,
                          callbacks=callbacks, seed=0, log_every_n_steps=1,
                          logger=CSVLogger(os.path.join(out_dir, f"logs_{rank}")))
        data = BaseDataModule(train=Samples(train), val=Samples(val),
                              batch_size_train=4 // world, batch_size_val=2 // world,
                              pin_memory=False)
        # the posterior noise a function of the row, the same on any rank
        with fixed_eps(np.full((1, LATENT), eps, np.float32)):
            trainer.fit(module, data, ckpt_path=ckpt_path)
        return trainer, module, record

    trainer, module, record = run(3, early=True)
    first = {"val": record.val, "epochs": record.epochs, "epoch": trainer.current_epoch,
             "step": trainer.global_step, "state": _state(module),
             "best": os.path.basename(trainer.checkpoint_callback.best_model_path)}
    last = os.path.join(out_dir, "ckpt_0", "last")
    trainer, module, record = run(3, ckpt_path=last)
    return {"first": first, "resumed": {"epochs": record.epochs, "val": record.val,
                                        "state": _state(module)}}


JOBS = {"steps": steps, "batch_norms": batch_norms, "streams": streams, "fit": fit,
        "unequal": unequal}


def run(rank: int, world: int, init_file: str, out_dir: str, jobs: list) -> None:
    """Rank ``rank`` of a gloo world: each ``(key, name, kwargs)`` of
    ``jobs``; the results by key into ``out_dir/rank<rank>.pt``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}",
                                         rank=rank, world_size=world)
    try:
        results = {key: JOBS[name](rank, world, **kw) for key, name, kw in jobs}
    finally:
        dist.destroy()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def join(rank: int, world: int, environ: dict, out_dir: str) -> None:
    """Rank ``rank`` joining by ``init_dist`` the group ``environ`` (its
    variables, set in this process's environment) describes; what it
    joined into ``out_dir/join<rank>.pt``."""
    torch.set_num_threads(1)
    os.environ.update({k: str(v).replace("{rank}", str(rank)) for k, v in environ.items()})
    size = dist.init_dist("cpu")
    try:
        got = {"size": size, "rank": dist.get_rank(), "world": dist.get_world_size(),
               "backend": torch.distributed.get_backend(), "local_rank": dist.local_rank(),
               "sum": float(dist.all_reduce_mean(float(rank + 1)) * world),
               "merged": dist.merge_results_dist([rank, -rank], os.path.join(out_dir, "parts"))}
    finally:
        dist.destroy()
    torch.save(got, os.path.join(out_dir, f"join{rank}.pt"))
