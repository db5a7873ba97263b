"""Data parallelism of the port on the CPU: worlds of two gloo processes
(``torch.multiprocessing`` spawned, joined by a ``file://`` store under
``tmp_path``) against a world of one over the concatenated batch, and
against the JAX ``Trainer(devices=2)`` on conftest's virtual CPU mesh.

The jobs the ranks run are in ``tests/_torch_ddp_worker.py``; a world of one
runs the same jobs in this process, with no group. Inputs come from numpy
seeds; the flagship is ``tests/test_sharding.py``'s tiny one at dropout 0,
with the JAX variables converted by ``flax_to_torch``, and the posterior
noise rows of one global draw, each rank given its own rows.

Limits (f32, summation order only; the ranks' sums of batch statistics and
gradients add in another order than one process's): those of
``test_train_step_matches_jax`` for whole steps, losses and gradient norms
1e-4 relative, the first step's gradients 1e-4 of each tensor's largest
entry, parameters 2e-6 + 1e-4 of a tensor's largest entry after three
AdamW steps (the tensors with an exact-zero gradient within 4 lr a step),
running statistics atol 1e-5; ``test_torch_training.py``'s 1e-5 for single
batch norms.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ddp_worker as W
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu.trainer import Trainer as JTrainer, TrainState
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import dist
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401
from test_torch_cli import REPO, _overrides, demos  # noqa: F401
from test_torch_fit import _stub_data, OPT as STUB_OPT, Stub
from test_torch_training import _ZERO_GRAD

WORLD = 2
B = 4  # the global batch: 2 rows a rank
N_POINTS = 256  # every cloud at one width: the ranks take the same routes
N_STEPS = 3
LR = W.OPT["lr"]
ATOL = 1e-5
# the accumulation's optimizer: linear in the gradients, where AdamW's
# normalisation can turn an element's rounding into a step of up to lr
SGD = {"type": "SGD", "lr": 1e-3, "momentum": 0.9}


def spawn(tmp_path, jobs, world=WORLD, target=None, args=None) -> list:
    """The ranks' results of ``jobs`` in a gloo world of ``world``."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    if target is None:
        target, args = W.run, (world, str(tmp_path / "store"), str(out), jobs)
    torch.multiprocessing.spawn(target, args=args, nprocs=world, join=True)
    name = "rank" if target is W.run else "join"
    return [torch.load(out / f"{name}{r}.pt", weights_only=False) for r in range(world)]


def _jax_policy():
    d = W.DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6),
        transformer=JTransformer(
            d_model=d, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=W.DIMS["ffn"], dropout=0.0, normalize_before=False,
            return_intermediate_dec=True, attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=W.DIMS["ffn"],
                                    num_layers=1, dropout=0.0),
        hidden_dim=d, num_queries=W.DIMS["chunk"], num_cameras=0, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0, pcd_nsample=W.DIMS["nsample"],
        pcd_npoints=W.DIMS["npoints"])


def _batch(seed):
    batch = tentry.build_batch(batch_size=B, n_points=N_POINTS, chunk=W.DIMS["chunk"],
                               seed=seed)
    batch["is_pad"] = np.arange(W.DIMS["chunk"])[None] >= np.array([[6], [4], [5], [3]])
    return batch


def _bn_arrays():
    """Rows of a masked batch norm's input with very unequal valid counts
    per rank (rank 0: 40 and 35 of 40; rank 1: 3 and 0), and of a token
    builder's with holes; the modules' variables, scales of both signs."""
    rng = np.random.RandomState(5)
    N, M, K, D, Cin = 30, 10, 5, 12, 6
    nn_idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn_idx[0, :3, 3:] = -1
    nn_idx[3, 4, :] = -1
    src = rng.randn(B, N, Cin).astype(np.float32)
    Wp = rng.randn(Cin, D).astype(np.float32)
    rows = {
        "x": (rng.randn(B, 40, 16) * 2 + 0.5).astype(np.float32),
        "mask": np.arange(40)[None] < np.array([[40], [35], [3], [0]]),
        "x_cot": rng.randn(B, 40, 16).astype(np.float32),
        "g": src @ Wp, "h": rng.randn(B, M, D).astype(np.float32), "src": src,
        "nn_idx": nn_idx, "cot": (rng.rand(B, M, D) + 0.5).astype(np.float32),
    }
    params = {"W": Wp}
    for name, d in (("masked", 16), ("xla", D), ("fused_data", D)):
        params.update({
            f"{name}.scale": (rng.uniform(0.5, 1.5, d) * rng.choice([-1.0, 1.0], d)
                              ).astype(np.float32),
            f"{name}.bias": (rng.randn(d) * 0.2).astype(np.float32),
            f"{name}.mean": (rng.randn(d) * 0.2).astype(np.float32),
            f"{name}.var": rng.uniform(0.5, 2.0, d).astype(np.float32)})
    return {"rows": rows, "params": params}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Three f32 AdamW + OneCycleLR steps and four k = 2 micro-steps at
    world 2 (spawned) and 1 (here), the batch norms and the streams at both,
    and the JAX 2-device mesh's three steps over the global batch."""
    tmp = tmp_path_factory.mktemp("ddp_steps")
    jpolicy = _jax_policy()
    batches = [_batch(seed) for seed in (0, 1)]
    # one global draw of the posterior noise for every step: the JAX step
    # is traced once, with the noise a constant of its program
    eps = [np.random.RandomState(0).randn(B, W.LATENT).astype(np.float32)] * 4
    jbatch = jax.tree.map(jnp.asarray, batches[0])
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(jbatch)
    variables = jax.tree.map(np.asarray, _randomize(variables, 7))
    module = BCModule(tentry.build_flagship(**W.DIMS, dropout=0.0, device="cpu"))
    module.load_variables(variables)
    state_file = str(tmp / "state.pt")
    torch.save(module.policy.state_dict(), state_file)

    jobs = [("steps", "steps", dict(state_file=state_file, batches=[batches[0]] * N_STEPS,
                                    eps=eps[:N_STEPS])),
            ("accumulate", "steps", dict(state_file=state_file, batches=batches * 2, eps=eps,
                                         accumulate=2, optimizer=SGD)),
            ("batch_norms", "batch_norms", dict(arrays=_bn_arrays())),
            ("streams", "streams", dict(state_file=state_file))]
    world2 = spawn(tmp, jobs + [("unequal", "unequal", dict(
        state_file=state_file, batch=batches[0], eps=eps[0]))])
    world1 = {key: W.JOBS[name](0, 1, **kw) for key, name, kw in jobs}

    # the JAX trainer over a 2-device mesh, the global batch sharded on it
    jmodule = JBCModule(jpolicy, optimizer=W.OPT, lr_scheduler=W.SCHED)
    jmodule.configure_optimizers(variables["params"], total_steps=W.TOTAL_STEPS)
    jtrainer = JTrainer(default_root_dir=str(tmp), devices=WORLD, precision="32-true",
                        prng_impl=None)
    state = jtrainer._replicate(TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=jmodule.tx.init(variables["params"]),
        rng=key))
    step = jtrainer._build_train_step(jmodule)
    sharded = jtrainer.shard_batch(batches[0])
    jax_metrics = []
    saved = jact.reparametrize
    jact.reparametrize = lambda mu, logvar, key: mu + jnp.exp(0.5 * logvar) * eps[0]
    try:
        for _ in range(N_STEPS):
            state, metrics = step(state, sharded)
            jax_metrics.append({k: float(v) for k, v in metrics.items()})
    finally:
        jact.reparametrize = saved
    jax_state = flax_to_torch({"params": jax.tree.map(np.asarray, state.params),
                               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
                              module.policy)
    return {"world2": world2, "world1": world1, "jax": (jax_metrics, jax_state),
            "mesh": jtrainer.mesh.devices.size}


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0,
                               err_msg=what)


def _assert_state(got: dict, ref: dict, what: str, lr: float = LR):
    for name, r in ref.items():
        r = r.numpy()
        if name.endswith((".mean", ".var")):
            atol = ATOL
        elif any(k in name for k in _ZERO_GRAD):
            atol = 4.0 * lr * N_STEPS
        else:
            atol = 2e-6 + 1e-4 * np.abs(r).max()
        _close(got[name], r, atol, f"{what}: {name}")


@pytest.mark.parametrize("key", ["loss", "action_loss", "kl_loss", "grad_norm"])
def test_world2_step_metrics_match_world1(steps, key):
    """Each of three steps' metrics at world 2, the same on both ranks, is
    world 1's over the concatenated batch."""
    ref = [m[key] for m in steps["world1"]["steps"]["metrics"]]
    for rank in steps["world2"]:
        np.testing.assert_allclose([m[key] for m in rank["steps"]["metrics"]], ref,
                                   rtol=1e-4, atol=0)


def test_world2_params_and_statistics_match_world1(steps):
    """After three steps: parameters and running statistics bit-equal on
    both ranks, and world 1's within the limits; the first step's gradients
    (global on each rank) world 1's."""
    r0, r1 = (r["steps"] for r in steps["world2"])
    for name, v in r0["state"].items():
        assert torch.equal(v, r1["state"][name]), name
    ref = steps["world1"]["steps"]
    _assert_state(r0["state"], ref["state"], "world 2 vs 1")
    for name, g in r0["grads"].items():
        want = ref["grads"][name].numpy()
        if any(k in name for k in _ZERO_GRAD):
            assert max(np.abs(want).max(), g.abs().max().item()) <= 1e-5, name
        else:
            _close(g, want, 1e-4 * np.abs(want).max(), f"grad {name}")
    # the epoch's metrics reduce over the ranks to world 1's
    for k, v in ref["epoch_metrics"].items():
        np.testing.assert_allclose([r["steps"]["epoch_metrics"][k] for r in steps["world2"]],
                                   v, rtol=1e-4)


def test_world2_matches_the_jax_two_device_mesh(steps):
    """World 2 against the JAX ``Trainer(devices=2)``'s GSPMD step over the
    global batch: losses, gradient norms, parameters and statistics."""
    jax_metrics, jax_state = steps["jax"]
    assert steps["mesh"] == WORLD
    got = steps["world2"][0]["steps"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                   [m[key] for m in jax_metrics], rtol=1e-4, atol=0)
    _assert_state(got["state"], jax_state, "world 2 vs JAX mesh")


def test_accumulation_at_world2(steps):
    """k = 2 at world 2 (SGD with momentum): each micro-step's
    ``grad_norm`` (the global micro-batch's) world 1's, the odd micro-steps
    leaving the parameters bit-equal on each rank, the end state world 1's
    and equal across ranks."""
    ref = steps["world1"]["accumulate"]
    for rank in steps["world2"]:
        got = rank["accumulate"]
        assert got["held"]
        np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]],
                                   [m["grad_norm"] for m in ref["metrics"]], rtol=1e-4, atol=0)
    r0, r1 = (r["accumulate"]["state"] for r in steps["world2"])
    assert all(torch.equal(v, r1[k]) for k, v in r0.items())
    _assert_state(r0, ref["state"], "k = 2", lr=SGD["lr"])


def test_unequal_local_batches_raise(steps):
    """The mean of the ranks' mean losses is the global mean only over
    equal local batches: a step over 1 and 2 rows raises on both ranks."""
    for rank in steps["world2"]:
        assert "local batches differ in size" in (rank["unequal"]["error"] or "")


@pytest.mark.parametrize("name", ["masked", "xla", "fused_data"])
def test_batch_statistics_are_global(steps, name):
    """``MaskedBatchNorm`` over very unequal valid counts per rank and
    ``GroupedBNReluMax`` on both routes with holes: outputs and input
    gradients (rows concatenated), parameter gradients (summed over the
    ranks) and running statistics (equal on both ranks) world 1's."""
    ref = steps["world1"]["batch_norms"][name]
    ranks = [r["batch_norms"][name] for r in steps["world2"]]
    for key, want in ref.items():
        if key in ("mean", "var"):
            assert torch.equal(ranks[0][key], ranks[1][key])
            got = ranks[0][key]
        elif key in ("dscale", "dbias", "dW"):
            got = ranks[0][key] + ranks[1][key]
        else:
            got = torch.cat([r[key] for r in ranks])
        _close(got, want.numpy(), ATOL * max(1.0, want.abs().max().item()), f"{name} {key}")


def test_streams_shared_and_own(steps):
    """The dense attention's mask stream and the kernels' seed stream draw
    alike on both ranks; the CVAE noise and BitsDropout's bits differ; a
    rank draws the same again from ``(seed, rank)``; a world of one draws
    its bits from the dropout generator itself."""
    (a, a2), (b, _) = (r["streams"]["draws"] for r in steps["world2"])
    assert torch.equal(a["dropout"], b["dropout"]) and a["seed"] == b["seed"]
    assert not torch.equal(a["bits"], b["bits"]) and not torch.equal(a["vae"], b["vae"])
    assert not a["bits_is_dropout"] and not b["bits_is_dropout"]
    for k in ("dropout", "bits", "vae"):
        assert torch.equal(a[k], a2[k])
    one = steps["world1"]["streams"]["draws"][0]
    assert one["bits_is_dropout"] and torch.equal(one["dropout"], a["dropout"])


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_fit")
    state_file = str(tmp / "state.pt")
    torch.save(tentry.build_flagship(**W.DIMS, dropout=0.0, device="cpu").state_dict(),
               state_file)
    train = tentry.build_batch(batch_size=16, n_points=N_POINTS, chunk=W.DIMS["chunk"], seed=3)
    val = tentry.build_batch(batch_size=4, n_points=N_POINTS, chunk=W.DIMS["chunk"], seed=4)
    out = {}
    for world in (1, WORLD):
        d = tmp / f"world{world}"
        d.mkdir()
        kw = dict(state_file=state_file, out_dir=str(d), train=train, val=val)
        if world == 1:
            out[world] = [W.fit(0, 1, **kw)]
        else:
            out[world] = [r["fit"] for r in spawn(d, [("fit", "fit", kw)])]
        out[f"{world}/files"] = {n: sorted(os.listdir(d / n)) for n in os.listdir(d)
                                 if (d / n).is_dir() and n != "out"}
    return out


def test_fit_at_world2_matches_world1(fits):
    """Two epochs over the loader: every epoch's ``val/loss`` and
    ``train/loss`` world 1's, on both ranks; ``samples_per_sec`` counted;
    the parameters at the end equal across ranks and world 1's."""
    ref = fits[1][0]["first"]
    for got in fits[WORLD]:
        got = got["first"]
        np.testing.assert_allclose(got["val"], ref["val"], rtol=1e-4)
        np.testing.assert_allclose([e[2] for e in got["epochs"]],
                                   [e[2] for e in ref["epochs"]], rtol=1e-4)
        assert [e[:2] for e in got["epochs"]] == [e[:2] for e in ref["epochs"]]
        assert all(e[3] for e in got["epochs"])
    r0, r1 = (r["first"]["state"] for r in fits[WORLD])
    assert all(torch.equal(v, r1[k]) for k, v in r0.items())
    _assert_state(r0, ref["state"], "fit")


def test_only_rank0_writes(fits):
    """Checkpoints (``last`` and the top-1) and the CSV log are written by
    rank 0 alone: rank 1's directories do not exist; both ranks name the
    same best checkpoint."""
    files = fits[f"{WORLD}/files"]
    # the first fit's top-1 and last, and the resumed fit's top-1 (a new
    # callback, whose top-k starts empty), as world 1 writes them
    assert files["ckpt_0"] == fits["1/files"]["ckpt_0"] == ["epoch_001", "epoch_002", "last"]
    assert files["logs_0"] == ["csv"]
    assert not any(n.endswith("_1") and n.startswith(("ckpt", "logs")) for n in files)
    assert fits[WORLD][0]["first"]["best"] == fits[WORLD][1]["first"]["best"] == "epoch_001"


def test_early_stopping_stops_every_rank_together(fits):
    """Only rank 0 holds an ``EarlyStopping`` that fires after the second
    validation: both ranks stop at epoch 1 of 3, as world 1 does."""
    for got in fits[WORLD] + fits[1]:
        assert got["first"]["epoch"] == 1 and len(got["first"]["epochs"]) == 2


def test_resume_at_world2(fits):
    """Both ranks restore rank 0's ``last`` and train epoch 2 alike, as
    world 1 does from its own."""
    ref = fits[1][0]["resumed"]
    r0, r1 = (r["resumed"] for r in fits[WORLD])
    assert [e[:2] for e in r0["epochs"]] == [e[:2] for e in ref["epochs"]] == [(2, 12)]
    assert all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())
    np.testing.assert_allclose(r0["val"], ref["val"], rtol=1e-4)
    _assert_state(r0["state"], ref["state"], "resumed")


def test_cli_trains_on_two_self_launched_processes(tmp_path, demos):  # noqa: F811
    """``python -m pointcloudmatters_tpu_torch.train trainer=ddp
    trainer.accelerator=cpu trainer.devices=2`` at tiny width: the entry
    point starts rank 1 itself, both train, rank 0 writes the run's files."""
    args = [a for a in _overrides(tmp_path, demos) if a != "trainer=cpu"]
    args += ["trainer=ddp", "trainer.accelerator=cpu", "trainer.devices=2",
             f"hydra.run.dir={tmp_path}/run"]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", "pointcloudmatters_tpu_torch.train", *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-6000:]
    assert "starting ranks 1-1 of 2" in out and "x 2 processes" in out
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints"))[-1] == "last"
    assert os.path.isfile(tmp_path / "run" / "csv" / "metrics.csv")


@pytest.mark.parametrize("launcher", ["torchrun", "slurm"])
def test_init_dist_joins_the_group_the_environment_describes(tmp_path, launcher):
    """Two processes given torchrun's or SLURM's variables join one gloo
    group by ``init_dist``, all-reduce across it and merge their results
    on rank 0 in rank order."""
    port = dist.free_port()
    environ = ({"RANK": "{rank}", "LOCAL_RANK": "{rank}", "WORLD_SIZE": WORLD,
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
               if launcher == "torchrun" else
               {"SLURM_PROCID": "{rank}", "SLURM_LOCALID": "{rank}", "SLURM_NTASKS": WORLD,
                "SLURM_NODELIST": "127.0.0.1", "MASTER_PORT": port})
    got = spawn(tmp_path, None, target=W.join, args=(WORLD, environ, str(tmp_path / "out")))
    for rank, g in enumerate(got):
        assert (g["size"], g["rank"], g["world"], g["backend"], g["local_rank"], g["sum"]) == (
            WORLD, rank, WORLD, "gloo", rank, 3.0)
        assert g["merged"] == ([0, 0, 1, -1] if rank == 0 else None)


def test_process_env_reads_torchrun_and_slurm():
    """torchrun's variables first, else SLURM's, whose node list gives the
    first host as the JAX package parses it; a world of one creates no
    group."""
    assert dist.process_env({}) is None
    env = dist.process_env({"SLURM_PROCID": "3", "SLURM_LOCALID": "1", "SLURM_NTASKS": "8",
                            "SLURM_NODELIST": "node[1-3],node5"})
    assert env == {"rank": 3, "local_rank": 1, "world": 8, "addr": "node1", "port": 29500}
    env = dist.process_env({"RANK": "1", "WORLD_SIZE": "2", "MASTER_PORT": "1234",
                            "SLURM_NTASKS": "8", "SLURM_PROCID": "0"})
    assert (env["rank"], env["world"], env["port"]) == (1, 2, 1234)
    assert dist.init_dist("cpu", {"RANK": "0", "WORLD_SIZE": "1"}) == 1
    assert not dist.is_initialized()


def test_devices_beyond_the_machine_raise(tmp_path, monkeypatch):
    """``devices`` above the card count raises, as Lightning does; more
    than one process asked of a process started alone raises; so does
    ``num_nodes`` > 1 without torchrun's or SLURM's variables."""
    dm = _stub_data(4)
    for var in ("RANK", "WORLD_SIZE", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="asks for 2 cards and this machine has 1"):
            Trainer(default_root_dir=str(tmp_path), accelerator="gpu", devices=2).fit(
                BCModule(Stub(), optimizer=STUB_OPT), dm)
    with pytest.raises(ValueError, match="runs alone"):
        Trainer(default_root_dir=str(tmp_path), accelerator="cpu", devices=2).fit(
            BCModule(Stub(), optimizer=STUB_OPT), dm)
    with pytest.raises(ValueError, match="torchrun or srun"):
        Trainer(default_root_dir=str(tmp_path), accelerator="cpu", num_nodes=2).fit(
            BCModule(Stub(), optimizer=STUB_OPT), dm)
    assert not dist.is_initialized()
