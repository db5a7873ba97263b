"""A JAX SGD checkpoint converted by ``flax_to_torch.jax_checkpoint_to_torch``
and continued by the port, against optax, on the CPU.

The JAX registry's SGD (``pointcloudmatters_tpu/utils/optimizer.py``) is
``add_decayed_weights`` (coupled L2) then ``optax.trace`` (momentum, with
Nesterov's update where asked) then the learning rate; without momentum it
has no trace. The port's is torch's SGD with dampening 0. Their algebra:

- torch's ``buf = m buf + g`` is optax's ``t = g + m t``, and Nesterov's
  update ``g + m buf`` is optax's ``g + m t``, so a trace carried over as
  ``momentum_buffer`` continues the same sequence;
- coupled weight decay adds ``wd p`` to ``g`` before both;
- a zero trace (a checkpoint before the first step) steps as torch's first
  ``buf = g``.

Each case builds JAX's ``build_optimizer`` chain over the parameters of the
tiny flagship ACT over PointNet (``_jax_policy``, seeded with numpy), takes
3 updates (none in the ``fresh`` case) from numpy-seeded gradient trees,
saves the checkpoint through ``ocp.PyTreeCheckpointer`` and restores it
without a template, converts it into a port ``BCModule`` configured alike,
then applies one more identical gradient in both. Every parameter agrees
within 1e-6 of its tensor's largest entry. The cases: momentum 0 and 0.9,
Nesterov off and on, weight decay 0 and 1e-4, with and without
``OneCycleLR`` (SGD keeps its configured momentum under it in both
packages), with and without ``MultiSteps`` (k = 2: the fourth gradient
completes a mean the checkpoint holds half of), and keyword-matched
``param_dicts`` (``multi_transform``: one trace a group).

States that do not convert still raise, naming what they hold. The port's
state written back in JAX's form (``tools/jax_form.py``'s ``torch_to_flax``,
which ``chip_smoke.py`` uses to hand the converter a checkpoint on the card)
is JAX's variables tree, leaf for leaf and bit for bit, and a momentum buffer
goes back to its trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import __graft_entry__ as jentry
from pointcloudmatters_tpu.utils import optimizer as jopt
from pointcloudmatters_tpu.utils import scheduler as jsched
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch, jax_checkpoint_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from tools.jax_form import torch_to_flax

TINY = dict(hidden_dim=32, chunk=5, enc_layers=1, dec_layers=2, nhead=4, npoints=16, nsample=4)
TOTAL = 8  # the schedule's optimizer steps
ONE_CYCLE = {"type": "OneCycleLR", "max_lr": 0.05, "pct_start": 0.3}
GROUPS = [{"keyword": "backbone", "lr": 0.01}, {"keyword": "transformer", "weight_decay": 0.0}]
# name -> (optimizer keywords, schedule, MultiSteps k, param_dicts, updates before the save)
CASES = {
    "no_momentum": (dict(), None, 1, None, 3),
    "no_momentum-decay": (dict(weight_decay=1e-4), None, 1, None, 3),
    "momentum": (dict(momentum=0.9), None, 1, None, 3),
    "momentum-decay": (dict(momentum=0.9, weight_decay=1e-4), None, 1, None, 3),
    "nesterov": (dict(momentum=0.9, nesterov=True), None, 1, None, 3),
    "nesterov-decay-onecycle": (dict(momentum=0.9, nesterov=True, weight_decay=1e-4),
                                ONE_CYCLE, 1, None, 3),
    "no_momentum-onecycle": (dict(), ONE_CYCLE, 1, None, 3),
    "momentum-multisteps": (dict(momentum=0.9), None, 2, None, 3),
    "nesterov-onecycle-multisteps": (dict(momentum=0.9, nesterov=True), ONE_CYCLE, 2, None,
                                     3),
    "no_momentum-decay-multisteps": (dict(weight_decay=1e-4), None, 2, None, 3),
    "param_dicts-momentum-decay-onecycle": (dict(momentum=0.9, weight_decay=1e-4), ONE_CYCLE,
                                            1, GROUPS, 3),
    "fresh-nesterov-decay": (dict(momentum=0.9, nesterov=True, weight_decay=1e-4), None, 1,
                             None, 0),
}


def _jax_policy():
    return jentry.build_flagship(**TINY)


@pytest.fixture(scope="module")
def variables():
    """The JAX policy's variables: shapes traced, values numpy-seeded
    (positive variances)."""
    batch = jax.tree.map(jnp.asarray, tentry.build_batch(batch_size=2, n_points=64, chunk=5))
    shapes = jax.eval_shape(lambda: _jax_policy().init(
        {"params": jax.random.PRNGKey(0), "vae": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(0)}, batch, train=True))
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: (rng.rand(*s.shape) + 0.5 if len(s.shape) == 1
                                   else rng.randn(*s.shape) * 0.1).astype(np.float32),
                        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


def _grads(params, t):
    rng = np.random.RandomState(100 + t)
    return jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)


def _jax_tx(cfg, sched, k, groups, params):
    schedule = None if sched is None else jsched.build_scheduler(sched, TOTAL, cfg["lr"])
    b1 = None if sched is None else jsched.build_momentum_schedule(sched, TOTAL)
    tx = jopt.build_optimizer(cfg, params=params, param_dicts=groups, lr_schedule=schedule,
                              b1_schedule=b1)
    return optax.MultiSteps(tx, every_k_schedule=k) if k > 1 else tx


def _apply(tx, grads, state, params):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _port_module(cfg, sched, k, groups):
    module = BCModule(tentry.build_flagship(device="cpu", **TINY), device="cpu",
                      optimizer=cfg, lr_scheduler=None if sched is None else {"scheduler": sched},
                      param_dicts=groups)
    module.configure_optimizers(TOTAL, accumulate_grad_batches=k)
    return module


@pytest.mark.parametrize("case", list(CASES))
def test_sgd_checkpoint_converts_and_continues_as_optax(case, variables, tmp_path):
    kw, sched, k, groups, steps = CASES[case]
    cfg = {"type": "SGD", "lr": 0.05, **kw}
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = _jax_tx(cfg, sched, k, groups, params)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: _apply(tx, g, s, p))
    for t in range(steps):
        params, state = update(_grads(variables["params"], t), state, params)
    item = {"params": jax.device_get(params), "batch_stats": variables["batch_stats"],
            "step": steps, "epoch": 0, "opt_state": jax.device_get(state)}
    ocp.PyTreeCheckpointer().save(str(tmp_path / "ckpt"), item, force=True)
    restored = ocp.PyTreeCheckpointer().restore(str(tmp_path / "ckpt"))

    module = _port_module(cfg, sched, k, groups)
    ckpt = jax_checkpoint_to_torch(restored, module)
    buffers = [s for s in ckpt["opt_state"]["optimizer"]["state"].values()]
    if kw.get("momentum"):
        assert len(buffers) == len(list(module.policy.parameters()))
        assert all(set(s) == {"momentum_buffer"} for s in buffers)
    else:
        assert buffers == []
    assert len(module.optimizer.param_groups) == (1 + len(groups) if groups else 1)
    module.policy.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]}, strict=True)
    module.optimizer.load_state_dict(ckpt["opt_state"]["optimizer"])
    if sched is not None:
        module.scheduler.load_state_dict(ckpt["opt_state"]["scheduler"])
        assert module.scheduler.last_epoch == steps // k
    if k > 1:
        module.gradient_mean.load_state_dict(ckpt["opt_state"]["gradient_mean"])
        assert module.gradient_mean.mini_step == steps % k

    g = _grads(variables["params"], steps)
    params, state = update(g, state, params)
    stats = variables["batch_stats"]
    port_g = flax_to_torch({"params": g, "batch_stats": stats}, module.policy)
    named = list(module.policy.named_parameters())
    for name, p in named:
        p.grad = port_g[name].clone()
    mean = module.gradient_mean
    stepped = mean is None or mean.update([p.grad for _, p in named])
    assert stepped  # the fourth gradient completes the mean of k = 2
    module.optimizer.step()
    if module.scheduler is not None:
        module.scheduler.step()
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, params), "batch_stats": stats},
                        module.policy)
    saved = ckpt["params"]
    for name, p in named:
        r = ref[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0,
                                   atol=1e-6 * float(np.abs(r).max()), err_msg=name)
        assert not np.array_equal(r, saved[name].numpy()), name


def _restored(tx, params):
    return {"params": jax.tree.map(np.asarray, params), "batch_stats": {}, "step": 0,
            "epoch": 0, "opt_state": jax.tree.map(np.asarray, tx.init(params))}


@pytest.mark.parametrize("cfg, jax_tx, held", [
    ({"type": "SGD", "lr": 0.05, "momentum": 0.9}, optax.lion(1e-3), "count/mu"),
    ({"type": "AdamW", "lr": 1e-3}, optax.sgd(1e-3, momentum=0.9), "trace"),
    ({"type": "SGD", "lr": 0.05, "momentum": 0.9}, optax.adam(1e-3), "count/mu/nu"),
], ids=["lion-into-sgd", "trace-into-adamw", "adam-into-sgd"])
def test_other_states_raise_naming_what_they_hold(cfg, jax_tx, held, variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    restored = _restored(jax_tx, params)
    restored["batch_stats"] = variables["batch_stats"]
    module = _port_module(cfg, None, 1, None)
    with pytest.raises(NotImplementedError, match=held):
        jax_checkpoint_to_torch(restored, module)


def test_a_trace_into_an_sgd_without_momentum_raises(variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    restored = _restored(optax.sgd(1e-3, momentum=0.9), params)
    restored["batch_stats"] = variables["batch_stats"]
    with pytest.raises(ValueError, match="no momentum"):
        jax_checkpoint_to_torch(restored, _port_module({"type": "SGD", "lr": 0.05}, None, 1,
                                                       None))


def _assert_trees_equal(got, ref, where=""):
    assert isinstance(got, dict) and set(got) == set(ref), (where, sorted(got), sorted(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(got[k], ref[k], f"{where}/{k}")
        else:
            r = np.asarray(ref[k])
            assert got[k].shape == r.shape and got[k].dtype == r.dtype, (where, k, got[k].shape)
            assert np.array_equal(got[k], r), (where, k)


def test_torch_to_flax_is_jax_form(variables):
    policy = tentry.build_flagship(device="cpu", **TINY)
    policy.load_state_dict(flax_to_torch(variables, policy), strict=True)
    _assert_trees_equal(torch_to_flax(policy), variables)
    grads = _grads(variables["params"], 7)
    named = flax_to_torch({"params": grads, "batch_stats": variables["batch_stats"]}, policy)
    buffers = {n: named[n] for n, _ in policy.named_parameters()}
    _assert_trees_equal(torch_to_flax(policy, buffers), grads)
