"""The port's learning-rate schedules, keyword-matched parameter groups, the
timm-style builder and the conversion of a grouped optimizer state, against
the JAX package's (``utils/scheduler.py``, ``utils/optimizer.py``,
``optax``), on the CPU.

- Every schedule of the registry at every step of a few ``total_steps``
  (and past them), rtol 1e-6: both run in f32 on the integer step
  (OneCycleLR computes in double in the port, within f32 rounding of
  JAX's). ``build_momentum_schedule`` gives beta1 only for OneCycleLR.
- The JAX path strings the groups match on (``jax_param_paths``) equal
  the paths of the JAX model's params tree, leaf for leaf, for the ACT
  over PointNet, the state-only ACT, the DP over PointNet, ACT over a
  ResNet and ``TransformerForDiffusion``.
- ``param_dicts`` and ``build_optimizer_v2``: the group each parameter
  lands in as JAX's labels put it, and every parameter after 3 steps
  within 1e-6 of optax's chain (AdamW with OneCycleLR's beta1 cycle in
  every group, Adam with coupled decay under timm's cosine, SGD with
  Nesterov momentum, layer decay).
- ``jax_checkpoint_to_torch`` takes a ``multi_transform`` state: the
  converted optimizer continues JAX's run within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import __graft_entry__ as jentry
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act import transformer as jtr
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion import (
    transformer_for_diffusion as jtfd,
)
from pointcloudmatters_tpu.utils import optimizer as jopt
from pointcloudmatters_tpu.utils import scheduler as jsched
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import (
    transformer_for_diffusion as ttfd,
)
from pointcloudmatters_tpu_torch.utils import optimizer as topt
from pointcloudmatters_tpu_torch.utils import scheduler as tsched
from pointcloudmatters_tpu_torch.utils.flax_to_torch import (
    jax_checkpoint_to_torch,
    jax_param_paths,
)
from test_torch_act_slice import threefry_prng  # noqa: F401

SCHEDULES = [
    {"type": "MultiStepLR", "milestones": [0.3, 0.5, 0.9], "gamma": 0.1},
    {"type": "MultiStepWithWarmupLR", "milestones": [0.5, 0.8], "gamma": 0.5,
     "warmup_rate": 0.1, "warmup_scale": 1e-3},
    {"type": "PolyLR", "power": 0.9},
    {"type": "ExpLR", "gamma": 0.5},
    {"type": "CosineAnnealingLR", "eta_min": 1e-5},
    {"type": "OneCycleLR", "max_lr": 2e-3, "pct_start": 0.25, "div_factor": 10.0},
    {"type": "CosineLRScheduler", "warmup_t": 3, "warmup_lr_init": 1e-5, "lr_min": 1e-6},
    {"type": "CosineLRScheduler", "warmup_t": 2, "warmup_prefix": True},
    {"type": "CosineLRScheduler", "cycle_limit": 3, "cycle_decay": 0.5, "t_initial": 6,
     "warmup_t": 2, "warmup_lr_init": 1e-5},
    {"type": "CosineLRScheduler", "cycle_mul": 2.0, "cycle_limit": 2, "t_initial": 4,
     "lr_min": 1e-5},
    {"type": "CosineLRScheduler", "k_decay": 1.5, "t_initial": 8, "warmup_t": 1,
     "warmup_prefix": True},
]
BASE_LR = 1e-3


@pytest.mark.parametrize("total", [10, 20, 37])
@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: c["type"])
def test_schedule_matches_jax_at_every_step(cfg, total):
    steps = np.arange(total + 4, dtype=np.int32)
    ref = np.asarray(jax.vmap(jsched.build_scheduler(cfg, total, BASE_LR))(jnp.asarray(steps)))
    kw = {k: v for k, v in cfg.items() if k != "type"}
    schedule = tsched.SCHEDULERS[cfg["type"]](base_lr=BASE_LR, total_steps=total, **kw)
    np.testing.assert_allclose([schedule(int(s)) for s in steps], ref, rtol=1e-6, atol=0)
    # stepped through an optimizer, every group at its scale
    w = torch.zeros(2, requires_grad=True)
    opt = topt.build_optimizer({"type": "SGD", "lr": BASE_LR}, [w])
    sched = tsched.build_scheduler(opt, cfg, total)
    for s in steps[:total]:
        np.testing.assert_allclose(opt.param_groups[0]["lr"], ref[s], rtol=1e-6, atol=0)
        opt.step()
        sched.step()


def test_beta1_cycles_only_under_one_cycle():
    for cfg in SCHEDULES:
        got = tsched.build_momentum_schedule(cfg, 20)
        ref = jsched.build_momentum_schedule(cfg, 20)
        assert (got is None) == (ref is None), cfg["type"]
        if got is not None:
            np.testing.assert_allclose([got(s) for s in range(24)],
                                       [float(ref(s)) for s in range(24)], atol=2e-7)
    assert tsched.build_momentum_schedule({"type": "OneCycleLR", "cycle_momentum": False},
                                          20) is None
    with pytest.raises(NotImplementedError):
        tsched.build_scheduler(topt.build_optimizer({"type": "AdamW", "lr": 1e-3},
                                                    [torch.zeros(1, requires_grad=True)]),
                               {"type": "OneCycleLR", "three_phase": True}, 10)


# ---------------------------------------------------------------------------
# JAX path strings
# ---------------------------------------------------------------------------

def _jax_paths(module, *args, **kw):
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "vae": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(0)}, *args, **kw))
    return {jopt._path_str(p) for p, _ in jax.tree_util.tree_leaves_with_path(shapes["params"])}


def _batch(**kw):
    return jax.tree.map(jnp.asarray, tentry.build_batch(**kw))


def test_paths_of_the_port_are_the_jax_trees():
    tiny = dict(hidden_dim=32, chunk=5, enc_layers=1, dec_layers=2, nhead=4)
    cases = [
        (tentry.build_flagship(npoints=16, nsample=4, device="cpu", **tiny),
         jentry.build_flagship(npoints=16, nsample=4, **tiny),
         (_batch(batch_size=2, n_points=64, chunk=5),), {"train": True}),
    ]
    sbatch = jax.tree.map(jnp.asarray, tentry.build_state_batch(2, env_state_dim=5, chunk=5))
    jstate = jact.ACT(
        backbone=None,
        transformer=jtr.Transformer(d_model=32, nhead=4, num_encoder_layers=1,
                                    num_decoder_layers=2, dim_feedforward=32,
                                    return_intermediate_dec=True),
        encoder=jtr.TransformerEncoder(d_model=32, nhead=8, dim_feedforward=32, num_layers=1),
        hidden_dim=32, num_queries=5, num_cameras=0, action_dim=7, qpos_dim=9,
        env_state_dim=5, goal_cond_dim=3)
    cases.append((tentry.build_state_policy(env_state_dim=5, device="cpu", **tiny), jstate,
                  (sbatch,), {"train": True}))
    tfd = dict(input_dim=4, output_dim=4, horizon=6, n_obs_steps=2, cond_dim=5, n_layer=2,
               n_head=2, n_emb=16, n_cond_layers=1, causal_attn=True)
    cases.append((ttfd.TransformerForDiffusion(**tfd), jtfd.TransformerForDiffusion(**tfd),
                  (jnp.zeros((2, 6, 4)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 2, 5))),
                  {}))
    for port, jmodel, args, kw in cases:
        got = jax_param_paths(port)
        assert set(got) == {n for n, _ in port.named_parameters()}
        assert set(got.values()) == _jax_paths(jmodel, *args, **kw), type(port).__name__


# ---------------------------------------------------------------------------
# groups and the timm-style builder against optax
# ---------------------------------------------------------------------------

SHAPES = {"backbone/conv1/kernel": (4, 3), "backbone/bn1/scale": (3,),
          "transformer/encoder/layers_0/linear1/kernel": (3, 5),
          "transformer/encoder/layers_1/linear1/bias": (5,),
          "patch_embed/proj/kernel": (2, 3), "blocks_0/mlp/kernel": (3, 3),
          "head/kernel": (5, 2), "query_embed": (4, 3)}


def _tree(flat):
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return {p: rng.randn(*s).astype(np.float32) for p, s in SHAPES.items()}


def _grads(t):
    rng = np.random.RandomState(100 + t)
    return {p: rng.randn(*s).astype(np.float32) for p, s in SHAPES.items()}


def _run(jtx, opt, sched, steps=3):
    """Three steps of optax's ``jtx`` and the torch ``opt`` on the same
    gradients; every parameter within 1e-6 after each."""
    w0 = _init()
    params = jax.tree.map(jnp.asarray, _tree(w0))
    state = jtx.init(params)
    tensors = {p: t for g in opt.param_groups for p, t in zip(g["paths"], g["params"])}
    for t in range(steps):
        g = _grads(t)
        updates, state = jtx.update(jax.tree.map(jnp.asarray, _tree(g)), state, params)
        params = optax.apply_updates(params, updates)
        for p, x in tensors.items():
            x.grad = torch.from_numpy(g[p])
        opt.step()
        if sched is not None:
            sched.step()
        ref = _flat(jax.tree.map(np.asarray, params))
        for p, x in tensors.items():
            np.testing.assert_allclose(x.detach().numpy(), ref[p], atol=1e-6, rtol=0,
                                       err_msg=f"step {t} {p}")


def _named(w0):
    return {p: torch.tensor(v, requires_grad=True) for p, v in w0.items()}


def _with_paths(opt, named):
    """Each group's JAX paths beside its tensors."""
    by_id = {id(t): p for p, t in named.items()}
    for g in opt.param_groups:
        g["paths"] = [by_id[id(t)] for t in g["params"]]
    return opt


GROUPS = [{"keyword": "backbone", "lr": 1e-4}, {"keyword": "linear1", "weight_decay": 0.0},
          {"keyword": "bn1", "lr": 5.0}]  # bn1 is in backbone: the first match wins


@pytest.mark.parametrize("opt_cfg, sched_cfg", [
    ({"type": "AdamW", "lr": 1e-2, "weight_decay": 0.1},
     {"type": "OneCycleLR", "max_lr": 1e-2, "pct_start": 0.3}),
    ({"type": "Adam", "lr": 1e-2, "weight_decay": 0.05},
     {"type": "CosineLRScheduler", "warmup_t": 1, "warmup_lr_init": 1e-3}),
    ({"type": "SGD", "lr": 1e-1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01},
     {"type": "MultiStepLR", "milestones": [0.3], "gamma": 0.5}),
    ({"type": "AdamW", "lr": 1e-2}, None),
], ids=["adamw-onecycle", "adam-timm", "sgd-nesterov", "adamw-constant"])
def test_param_dicts_match_optax(opt_cfg, sched_cfg):
    total = 4
    schedule = b1 = None
    if sched_cfg is not None:
        schedule = jsched.build_scheduler(sched_cfg, total, opt_cfg["lr"])
        b1 = jsched.build_momentum_schedule(sched_cfg, total)
    w0 = _init()
    jtx = jopt.build_optimizer(opt_cfg, params=jax.tree.map(jnp.asarray, _tree(w0)),
                               param_dicts=GROUPS, lr_schedule=schedule, b1_schedule=b1)
    named = _named(w0)
    opt = _with_paths(topt.build_optimizer(opt_cfg, named, param_dicts=GROUPS), named)
    assert [sorted(g["paths"]) for g in opt.param_groups] == [
        sorted(p for p in SHAPES if "backbone" not in p and "linear1" not in p),
        ["backbone/bn1/scale", "backbone/conv1/kernel"],
        sorted(p for p in SHAPES if "linear1" in p), []]
    sched = None if sched_cfg is None else tsched.build_scheduler(opt, sched_cfg, total)
    _run(jtx, opt, sched)


@pytest.mark.parametrize("cfg", [
    {"type": "AdamW", "lr": 1e-2, "weight_decay": 0.05, "layer_decay": 0.5},
    {"type": "AdamW", "lr": 1e-2, "weight_decay": 0.05, "filter_bias_and_bn": False},
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.05, "layer_decay": 0.75},
    {"type": "SGD", "lr": 1e-1, "momentum": 0.9, "nesterov": True, "weight_decay": 0.01,
     "layer_decay": 0.5},
    {"type": "sgd", "lr": 1e-1},
], ids=["adamw-layers", "adamw-unfiltered", "adam-layers", "sgd-nesterov-layers", "sgd"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_timm_builder_matches_optax(cfg, scheduled):
    w0 = _init()
    jschedule = jsched.build_scheduler({"type": "CosineAnnealingLR"}, 4, cfg["lr"]) \
        if scheduled else None
    jtx = jopt.build_optimizer_v2(cfg, jax.tree.map(jnp.asarray, _tree(w0)),
                                  lr_schedule=jschedule)
    named = _named(w0)
    schedule = tsched.cosine_annealing_lr(cfg["lr"], 4) if scheduled else None
    opt, sched = topt.build_optimizer_v2(cfg, named, lr_schedule=schedule)
    assert (sched is None) == (not scheduled)
    if "layer_decay" in cfg:
        jscales, jmask = jopt.param_groups_layer_decay(jax.tree.map(jnp.asarray, _tree(w0)),
                                                       layer_decay=cfg["layer_decay"])
        scales, mask = topt.param_groups_layer_decay(named, layer_decay=cfg["layer_decay"])
        assert scales == _flat(jscales) and mask == _flat(jmask)
    _run(jtx, _with_paths(opt, named), sched)
    with pytest.raises(KeyError):
        topt.build_optimizer_v2({"type": "LAMB", "lr": 1e-3}, named)


# ---------------------------------------------------------------------------
# a grouped optimizer state converted
# ---------------------------------------------------------------------------

class _JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(3, name="head")(fnn.LayerNorm(name="norm")(fnn.Dense(4, name="body")(x)))


class _TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Linear(2, 4)
        self.norm = torch.nn.LayerNorm(4)
        self.head = torch.nn.Linear(4, 3)


def test_a_multi_transform_state_converts_and_continues():
    opt_cfg = {"type": "AdamW", "lr": 1e-2, "weight_decay": 0.1}
    sched_cfg = {"type": "OneCycleLR", "max_lr": 1e-2, "pct_start": 0.3}
    groups = [{"keyword": "head", "lr": 1e-3}, {"keyword": "norm", "weight_decay": 0.0}]
    total = 6
    params = _JTiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))["params"]
    jtx = jopt.build_optimizer(opt_cfg, params=params, param_dicts=groups,
                               lr_schedule=jsched.build_scheduler(sched_cfg, total, 1e-2),
                               b1_schedule=jsched.build_momentum_schedule(sched_cfg, total))
    state = jtx.init(params)
    rng = np.random.RandomState(0)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32), params)
             for _ in range(3)]
    for g in grads[:2]:
        updates, state = jtx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    restored = {"params": params, "batch_stats": {}, "step": 2, "epoch": 0, "opt_state": state}

    module = BCModule(_TTiny(), device="cpu", optimizer=opt_cfg,
                      lr_scheduler={"scheduler": sched_cfg}, param_dicts=groups)
    module.configure_optimizers(total)
    ckpt = jax_checkpoint_to_torch(jax.tree.map(np.asarray, restored), module)
    module.policy.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]})
    module.optimizer.load_state_dict(ckpt["opt_state"]["optimizer"])
    module.scheduler.load_state_dict(ckpt["opt_state"]["scheduler"])
    assert module.scheduler.last_epoch == 2
    updates, state = jtx.update(grads[2], state, params)
    params = optax.apply_updates(params, updates)
    from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, params)}, module.policy)
    g3 = flax_to_torch({"params": jax.tree.map(np.asarray, grads[2])}, module.policy)
    for name, p in module.policy.named_parameters():
        p.grad = g3[name]
    module.optimizer.step()
    for name, p in module.policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
