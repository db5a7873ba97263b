"""Parity of the port's training side with the JAX package, f32, on the CPU:
batch norms in train mode, losses, optimizer and schedule, and the whole
training step of a tiny flagship.

Inputs and noise come from numpy seeds; JAX variables are converted with
``flax_to_torch``. Tolerances: atol 1e-5 for single modules (f32, only
summation order differs); optimizer trajectories atol 2e-6, as
``tests/test_training.py`` holds optax against torch; the whole step's
limits are stated in its docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components import nn_utils as jnn
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.models.components.loss import misc as jloss
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu.trainer import Trainer as JTrainer, TrainState
from pointcloudmatters_tpu.utils.optimizer import build_optimizer as jbuild_optimizer
from pointcloudmatters_tpu.utils.scheduler import (
    build_momentum_schedule as jbuild_momentum,
    build_scheduler as jbuild_scheduler,
)
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.models.components.loss import misc as tloss
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from pointcloudmatters_tpu_torch.utils.metrics import MaxMetric, MeanMetric, Metrics
from pointcloudmatters_tpu_torch.utils.optimizer import build_optimizer
from pointcloudmatters_tpu_torch.utils.scheduler import build_scheduler
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# batch norms in train mode
# ---------------------------------------------------------------------------

def _bn_case(jm, tm, jargs, targs, variables, cotangent):
    """JAX apply(mutable=["batch_stats"]) and its vjp against the port's
    forward, backward and in-place running statistics."""
    def f(params, *xs):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        *xs, use_running_average=False, mutable=["batch_stats"])
    ref, vjp, mut = jax.vjp(f, variables["params"], *jargs, has_aux=True)
    grads = vjp(jnp.asarray(cotangent))
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    got = tm(*targs, use_running_average=False)
    got.backward(_t(cotangent))
    _close(got, ref, what="output")
    _close(tm.scale.grad, grads[0]["scale"], what="d scale")
    _close(tm.bias.grad, grads[0]["bias"], what="d bias")
    _close(tm.mean, mut["batch_stats"]["mean"], what="running mean")
    _close(tm.var, mut["batch_stats"]["var"], what="running var")
    return grads[1:]


def test_masked_batch_norm_train():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 16).astype(np.float32) * 2 + 0.5
    mask = np.arange(40)[None] < np.array([[40], [23], [7]])
    jm = jnn.MaskedBatchNorm(momentum=0.01, eps=1e-3)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    xt = _t(x).requires_grad_()
    cot = rng.randn(*x.shape).astype(np.float32)
    dx, _ = _bn_case(jm, tnn.MaskedBatchNorm(16, momentum=0.01, eps=1e-3),
                     (jnp.asarray(x), jnp.asarray(mask)), (xt, _t(mask)),
                     variables, cot)
    _close(xt.grad, dx, what="d x")


@pytest.mark.parametrize("tie", [False, True])
def test_grouped_bn_relu_max_train(tie):
    """Holes, effective scales of both signs and, with ``tie``, a holed
    token whose largest gathered row is exactly zero: max(0, 0) splits the
    gradient 0.5/0.5 under jnp.maximum (torch.clamp_min passed all of it)."""
    rng = np.random.RandomState(2)
    B, N, M, K, D = 2, 30, 10, 5, 12
    g = rng.randn(B, N, D).astype(np.float32)
    h = rng.randn(B, M, D).astype(np.float32)
    nn_idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn_idx[0, :3, 3:] = -1
    nn_idx[1, 4, :] = -1
    if tie:  # token (0, 0): neighbours 0..2 distinct rows, 3..4 holes
        nn_idx[0, 0, :3] = [5, 6, 7]
        g[0, 5] = h[0, 0]            # x = 0 exactly in every channel
        g[0, 6] = h[0, 0] - 1.0      # x = -1
        g[0, 7] = h[0, 0] - 2.0      # x = -2
    jm = jnn.GroupedBNReluMax()
    jargs = tuple(jnp.asarray(a) for a in (g, h, nn_idx))
    variables = _randomize(jm.init(jax.random.PRNGKey(0), *jargs), 3)
    scale = np.asarray(variables["params"]["scale"])
    assert (scale < 0).any() and (scale > 0).any()
    if tie:  # positive bias where the scale is positive: the tie is live
        bias = np.abs(np.asarray(variables["params"]["bias"])) + 0.1
        variables = {"params": {**variables["params"], "bias": bias},
                     "batch_stats": variables["batch_stats"]}
    gt, ht = _t(g).requires_grad_(), _t(h).requires_grad_()
    cot = rng.rand(B, M, D).astype(np.float32) + 0.5
    dg, dh, _ = _bn_case(jm, tnn.GroupedBNReluMax(D), jargs, (gt, ht, _t(nn_idx)),
                         variables, cot)
    _close(gt.grad, dg, what="d g")
    _close(ht.grad, dh, what="d h")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "l1", "L1Loss", {"type": "MSELoss"}])
def test_losses_match_jax(name):
    rng = np.random.RandomState(3)
    a_hat, actions = rng.randn(2, 2, 6, 7).astype(np.float32)
    is_pad = np.arange(6)[None] >= np.array([[6], [4]])
    mu, logvar = rng.randn(2, 3, 8).astype(np.float32)[:2] * 0.5
    ref = jloss.masked_action_loss(jloss.build_action_loss(name), *map(jnp.asarray, (
        a_hat, actions, is_pad)))
    got = tloss.masked_action_loss(tloss.build_action_loss(name), _t(a_hat), _t(actions),
                                   _t(is_pad))
    _close(got, ref)
    _close(tloss.KLDivergence()(_t(mu), _t(logvar)),
           jloss.KLDivergence()(jnp.asarray(mu), jnp.asarray(logvar)))
    assert float(tloss.KLDivergence()(None, None)) == 0.0


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

W0 = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
G0 = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)


@pytest.mark.parametrize("T", [1, 2, 30])
def test_one_cycle_adamw_matches_jax(T):
    """LR, beta1 and parameters per step against the JAX chain (OneCycleLR
    with beta1 cycling); T=1 and T=2 are the degenerate totals the JAX
    schedule clamps."""
    lr, wd = 1e-2, 0.1
    sched_cfg = {"type": "OneCycleLR", "max_lr": lr, "pct_start": 0.3}
    opt_cfg = {"type": "AdamW", "lr": lr, "weight_decay": wd}
    schedule = jbuild_scheduler(sched_cfg, T, lr)
    b1 = jbuild_momentum(sched_cfg, T)
    tx = jbuild_optimizer(opt_cfg, lr_schedule=schedule, b1_schedule=b1)
    params = {"w": jnp.asarray(W0)}
    state = tx.init(params)

    tw = torch.tensor(W0, requires_grad=True)
    opt = build_optimizer(opt_cfg, [tw])
    sched = build_scheduler(opt, sched_cfg, T)
    for t in range(T):
        group = opt.param_groups[0]
        # the JAX schedules run in f32
        np.testing.assert_allclose(group["lr"], float(schedule(t)), rtol=1e-5)
        np.testing.assert_allclose(group["betas"][0], float(b1(t)), atol=2e-6)
        g = G0 * (1.0 + 0.1 * t)
        tw.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]),
                                   atol=2e-6, err_msg=f"step {t}")
    assert np.isfinite(opt.param_groups[0]["lr"])


@pytest.mark.parametrize("T", [2, 30])
def test_one_cycle_runs_past_total_like_jax(T):
    """Past ``total_steps`` the learning rate and beta1 stay where the JAX
    schedules clip them (the end of the anneal), with no error."""
    lr = 1e-2
    sched_cfg = {"type": "OneCycleLR", "max_lr": lr, "pct_start": 0.3}
    schedule = jbuild_scheduler(sched_cfg, T, lr)
    b1 = jbuild_momentum(sched_cfg, T)
    opt = build_optimizer({"type": "AdamW", "lr": lr}, [torch.zeros(2, requires_grad=True)])
    sched = build_scheduler(opt, sched_cfg, T)
    for t in range(T + 5):
        group = opt.param_groups[0]
        np.testing.assert_allclose(group["lr"], float(schedule(t)), rtol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(group["betas"][0], float(b1(t)), atol=2e-6)
        opt.step()
        sched.step()
    np.testing.assert_allclose(opt.param_groups[0]["lr"], lr / 25.0 / 1e4, rtol=1e-5)


@pytest.mark.parametrize("cfg", [
    {"type": "Adam", "lr": 1e-2, "weight_decay": 0.1},
    {"type": "SGD", "lr": 1e-1, "momentum": 0.9, "weight_decay": 0.1},
    {"type": "SGD", "lr": 1e-1, "momentum": 0.9, "nesterov": True},
])
def test_coupled_decay_optimizers_match_jax(cfg):
    tx = jbuild_optimizer(cfg)
    params = {"w": jnp.asarray(W0)}
    state = tx.init(params)
    tw = torch.tensor(W0, requires_grad=True)
    opt = build_optimizer(cfg, [tw])
    for t in range(5):
        g = G0 * (1.0 - 0.2 * t)
        tw.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]),
                                   atol=2e-6, err_msg=f"step {t}")


def test_unported_training_options_raise():
    """What JAX refuses the port refuses; keyword-matched groups and the
    other schedulers are ported (``tests/test_torch_schedules_groups.py``)."""
    tw = torch.zeros(2, requires_grad=True)
    with pytest.raises(ValueError, match="names"):  # groups match on the paths
        build_optimizer({"type": "AdamW", "lr": 1e-3}, [tw],
                        param_dicts=[{"keyword": "w", "lr": 1e-4}])
    opt = build_optimizer({"type": "AdamW", "lr": 1e-3}, {"w": tw},
                          param_dicts=[{"keyword": "w", "lr": 1e-4}])
    assert [g["lr_scale"] for g in opt.param_groups] == [1.0, pytest.approx(0.1)]
    with pytest.raises(NotImplementedError):
        build_optimizer({"type": "LAMB", "lr": 1e-3}, [tw])
    opt = build_optimizer({"type": "AdamW", "lr": 1e-3}, [tw])
    for kind in ("CosineAnnealingLR", "PolyLR", "ExpLR", "CosineLRScheduler"):
        assert build_scheduler(opt, {"type": kind}, 10).lr_at(0) > 0
    with pytest.raises(KeyError):
        build_scheduler(opt, {"type": "StepLR"}, 10)
    for extra in ({"three_phase": True}, {"anneal_strategy": "linear"}):  # JAX raises too
        with pytest.raises(NotImplementedError):
            build_scheduler(opt, {"type": "OneCycleLR", **extra}, 10)
    for precision in ("bf16-mixed", "16-mixed"):  # ported: bf16 compute
        assert Trainer(precision=precision).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        Trainer(precision="64-true")
    module = BCModule(torch.nn.Linear(2, 2), param_dicts=[{"keyword": "kernel"}])
    module.configure_optimizers(4)
    assert [len(g["params"]) for g in module.optimizer.param_groups] == [1, 1]
    assert isinstance(Metrics(["MaxMetric"], ["loss"], ["best"]).metrics[0], MaxMetric)
    with pytest.raises(KeyError):
        Metrics(["MedianMetric"], ["loss"], ["median"])


def test_mean_metric_skips_nan_and_stays_a_tensor():
    m = MeanMetric()
    for v, w in ((1.0, 1.0), (float("nan"), 1.0), (4.0, 2.0)):
        m.update(torch.tensor(v), w)
    out = m.compute()
    assert torch.is_tensor(out) and abs(float(out) - 3.0) < 1e-12
    m.reset()
    assert np.isnan(float(m.compute()))


# ---------------------------------------------------------------------------
# the whole training step
# ---------------------------------------------------------------------------

DIMS = dict(hidden_dim=32, npoints=16, nsample=4, chunk=5, enc_layers=2,
            dec_layers=3, nhead=4)
OPT = {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05}
SCHED = {"scheduler": {"type": "OneCycleLR", "max_lr": 1e-3, "pct_start": 0.1,
                       "anneal_strategy": "cos", "div_factor": 100.0,
                       "final_div_factor": 1000.0}}
TOTAL_STEPS = 30
N_STEPS = 5
# parameters whose exact gradient is zero (see test_train_step_matches_jax)
_ZERO_GRAD = ("self_attn.key.bias", "multihead_attn.key.bias",
              "decoder.layers.0.self_attn.query.", "decoder.layers.0.self_attn.key.")


def _jax_flagship_no_dropout():
    """``__graft_entry__.build_flagship`` at DIMS with dropout 0."""
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6),
        transformer=JTransformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True,
            attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7,
        qpos_dim=9, goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"],
    )


def test_train_step_matches_jax(monkeypatch, tmp_path):
    """Five steps of the JAX ``Trainer(precision="32-true")`` and of the
    port's ``Trainer.train_step`` from the same variables and batch, dropout
    0, the posterior noise fixed to one numpy array on both sides.

    Limits: per-step losses rtol 1e-4 and the first step's gradients 1e-4
    of each tensor's largest entry (a dozen f32 layers deep, summation order
    only). After five steps, batch statistics atol 1e-5 (running averages
    of f32 sums) and parameters atol 2e-6 + 1e-4 of a tensor's largest
    entry.

    Some tensors have an exact gradient of zero (``_ZERO_GRAD``): the key
    biases, since softmax is invariant to a per-row shift, and the first
    decoder layer's self-attention query and key, whose values (the zero
    targets' projection) are the same for every key. Both sides hold only
    rounding noise there (|g| <= 1e-5, against gradients of order 1e2
    elsewhere), and AdamW normalises noise to steps of about lr, in either
    direction: those parameters are held only to within 4 lr of each other
    a step."""
    rng = np.random.RandomState(0)
    batch = jentry.build_batch(batch_size=2, n_points=256, chunk=DIMS["chunk"])
    batch["is_pad"] = np.arange(DIMS["chunk"])[None] >= np.array([[5], [3]])
    eps = rng.randn(2, 32).astype(np.float32)
    monkeypatch.setattr(jact, "reparametrize",
                        lambda mu, logvar, key: mu + jnp.exp(0.5 * logvar) * eps)
    monkeypatch.setattr(tact, "reparametrize",
                        lambda mu, logvar, gen: mu + torch.exp(0.5 * logvar) * _t(eps))

    jpolicy = _jax_flagship_no_dropout()
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(jbatch)
    variables = jax.tree.map(np.asarray, _randomize(variables, 7))

    jmodule = JBCModule(jpolicy, optimizer=OPT, lr_scheduler=SCHED)
    jmodule.configure_optimizers(variables["params"], total_steps=TOTAL_STEPS)
    jtrainer = JTrainer(default_root_dir=str(tmp_path), precision="32-true",
                        prng_impl=None)
    step = jtrainer._build_train_step(jmodule)

    def loss_fn(params):
        out, _ = jmodule.apply_train(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch,
            rngs=jmodule.make_rngs(key))
        return out["loss"]

    jgrads = jax.grad(loss_fn)(variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jmodule.tx.init(variables["params"]), rng=key)
    jlosses = []
    for _ in range(N_STEPS):
        state, metrics = step(state, jbatch)
        jlosses.append(float(metrics["loss"]))

    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu"),
                      optimizer=OPT, lr_scheduler=SCHED)
    module.load_variables(variables)
    trainer = Trainer(precision="32-true", seed=0)
    trainer.setup(module, TOTAL_STEPS)
    losses, lrs = [], []
    for i in range(N_STEPS):
        lrs.append(module.optimizer.param_groups[0]["lr"])
        losses.append(float(trainer.train_step(module, batch)["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in module.policy.named_parameters()}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)

    ref_grads = flax_to_torch({"params": jgrads,
                               "batch_stats": variables["batch_stats"]},
                              module.policy)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        if any(k in name for k in _ZERO_GRAD):
            assert max(np.abs(ref).max(), g.abs().max().item()) <= 1e-5, name
        else:
            _close(g, ref, atol=1e-4 * np.abs(ref).max(), what=f"grad {name}")

    final = flax_to_torch({"params": jax.tree.map(np.asarray, state.params),
                           "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
                          module.policy)
    state_now = module.policy.state_dict()
    for name, ref in final.items():
        ref = ref.numpy()
        if name.endswith((".mean", ".var")):
            atol = ATOL
        elif any(k in name for k in _ZERO_GRAD):
            atol = 4.0 * sum(lrs)
        else:
            atol = 2e-6 + 1e-4 * np.abs(ref).max()
        _close(state_now[name], ref, atol=atol, what=name)
