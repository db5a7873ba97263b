"""The port's ``"bf16-mixed"`` training step against the JAX ``Trainer``'s,
on the CPU, and the bf16 oneshot attention's plain version against the JAX
attention's CPU path.

Both steps cast every floating parameter and batch array to bf16, keep the
batch statistics f32, take the loss in f32 and update f32 masters with
AdamW. The two frameworks round bf16 at different places inside a layer
(XLA keeps fused elementwise chains in f32 under ``jit``; PyTorch rounds
every op), so the limits here are bf16-sized, set from the worst cases
measured on these inputs (in brackets) with a margin of 2-6x:

- the attention, bf16 plain oneshot against flax's dense
  ``dot_product_attention`` at bf16 (the JAX oneshot's CPU path): output
  and dq/dk/dv within 2e-2 of each tensor's largest entry [5.7e-3 to
  7.2e-3]; a bf16 ulp is 2^-8 relative and the two round the scores, the
  weights and the products at different points;
- the step: the loss within 1e-2 relative [1.6e-3]; each gradient within
  0.2 of its tensor's largest entry [0.082], the size bf16 noise reaches
  through a dozen layers, except the tensors whose exact gradient is 0
  (``_ZERO_GRAD``, see ``tests/test_torch_training.py``): there both sides
  hold noise only, within 5e-3 of the model's largest gradient entry
  [2.3e-3]; batch statistics within 1e-3 relative + 1e-5 [4.9e-5, 6e-7];
  the f32 masters after one AdamW step within 1e-6 where the gradient is
  signal (at least 0.25 of its tensor's largest entry), else within 2 lr
  + 1e-6 (a first Adam step moves each entry by lr times the sign of its
  gradient, which noise may flip where the gradient is near 0).

Inputs and the posterior noise come from numpy seeds (the noise cast to the
compute type on both sides); dropout is 0. The JAX side's FPS and kNN get
f32 coordinates, as its TPU kernels upcast them (``pallas_fps.py:85``,
``pallas_knn3.py:117-118``) and the port's dispatch does; on the CPU its
XLA fallbacks would otherwise compute distances in bf16.
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
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu.ops import fused_builder as jfb
from pointcloudmatters_tpu.ops.attention import make_oneshot_attention_fn as jax_attention_fn
from pointcloudmatters_tpu.trainer import Trainer as JTrainer, TrainState, _cast_floating
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

BF16 = torch.bfloat16
DIMS = dict(hidden_dim=32, npoints=16, nsample=4, chunk=5, enc_layers=1,
            dec_layers=2, nhead=4)
LR = 1e-3
OPT = {"type": "AdamW", "lr": LR, "weight_decay": 0.05}
# tensors whose exact gradient is zero: key biases (softmax is invariant to
# a per-row shift) and the first decoder layer's self-attention query and
# key (its values are the same for every key)
_ZERO_GRAD = ("self_attn.key.bias", "multihead_attn.key.bias",
              "decoder.layers.0.self_attn.query.", "decoder.layers.0.self_attn.key.")


def _rel(got, ref) -> float:
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1e-12, np.abs(ref).max()))


def test_bf16_oneshot_plain_matches_jax_attention():
    """Forward and gradients at bf16: the port's oneshot autograd function
    on the CPU (its plain versions) against ``jax.grad`` through the JAX
    package's oneshot attention function (its dense route off the TPU)."""
    B, H, Lq, Lk, dh = 2, 4, 70, 300, 64
    rng = np.random.RandomState(0)
    q, k, v, g = (rng.randn(B, L, H, dh).astype(np.float32)
                  for L in (Lq, Lk, Lk, Lq))

    def jloss(q, k, v):
        out = jax_attention_fn()(q, k, v, deterministic=True)
        return jnp.sum(out.astype(jnp.float32) * g), out

    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                     has_aux=True))(*jb)
    tq, tk, tv = (torch.from_numpy(a).to(BF16).requires_grad_() for a in (q, k, v))
    out = tone.oneshot_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                 tv.transpose(1, 2), dh ** -0.5).transpose(1, 2)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == BF16 and tq.grad.dtype == BF16
    assert _rel(out, ref) < 2e-2
    for name, got, want in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref_grads):
        assert _rel(got, want) < 2e-2, name


def _jax_policy(freeze_backbone=False, pre_sample=False):
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6, num_classes=d if pre_sample else 0),
        transformer=JTransformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True,
            attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7,
        qpos_dim=9, goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"], freeze_backbone=freeze_backbone,
        pre_sample=pre_sample,
    )


def _fused_route(monkeypatch):
    """Both packages' builders on their fused route, on the CPU: the JAX
    one through its own plain reference (``impl="xla"``)."""
    monkeypatch.setitem(jfb._BUILDERS, "pallas", jfb._BUILDERS["xla"])
    monkeypatch.setattr(jnn.GroupedBNReluMax, "resolve_impl",
                        staticmethod(lambda *a: "fused"))
    monkeypatch.setattr(tnn.GroupedBNReluMax, "resolve_impl",
                        staticmethod(lambda *a: "fused"))


def _common_patches(monkeypatch, eps):
    f32 = jnp.float32
    fps, knn = jact.farthest_point_sampling_padded, jact.knn_query_padded
    monkeypatch.setattr(jact, "farthest_point_sampling_padded",
                        lambda xyz, mask, n: fps(xyz.astype(f32), mask, n))
    monkeypatch.setattr(jact, "knn_query_padded",
                        lambda q, xyz, mask, k: knn(q.astype(f32), xyz.astype(f32), mask, k))
    monkeypatch.setattr(jact, "reparametrize", lambda mu, logvar, key: (
        mu + jnp.exp(0.5 * logvar) * jnp.asarray(eps, mu.dtype)))
    monkeypatch.setattr(tact, "reparametrize", lambda mu, logvar, gen: (
        mu + torch.exp(0.5 * logvar) * torch.from_numpy(eps).to(mu.dtype)))


def _batch():
    batch = jentry.build_batch(batch_size=2, n_points=256, chunk=DIMS["chunk"])
    batch["is_pad"] = np.arange(DIMS["chunk"])[None] >= np.array([[5], [3]])
    return batch


@pytest.mark.parametrize("variant", ["shipped", "frozen", "pre_sample"])
def test_bf16_mixed_step_matches_jax(variant, monkeypatch, tmp_path):
    """One ``Trainer(precision="bf16-mixed")`` step of a small flagship,
    port against JAX from the same variables and batch: the shipped
    flagship, its frozen-backbone variant (both builders on their fused
    route) and the ``pre_sample`` variant (D = 6: the plain chain)."""
    kw = {"frozen": dict(freeze_backbone=True),
          "pre_sample": dict(pre_sample=True)}.get(variant, {})
    eps = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    _common_patches(monkeypatch, eps)
    if variant == "frozen":
        _fused_route(monkeypatch)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jpolicy = _jax_policy(**kw)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(jbatch)
    variables = jax.tree.map(np.asarray, _randomize(variables, 7))

    jmodule = JBCModule(jpolicy, optimizer=OPT)
    jmodule.configure_optimizers(variables["params"], total_steps=10)
    step = JTrainer(default_root_dir=str(tmp_path), precision="bf16-mixed",
                    prng_impl=None)._build_train_step(jmodule)

    def loss_fn(params):  # the step's own loss, for its gradients
        out, _ = jmodule.apply_train(
            {"params": _cast_floating(params, jnp.bfloat16),
             "batch_stats": variables["batch_stats"]},
            _cast_floating(jbatch, jnp.bfloat16), rngs=jmodule.make_rngs(key))
        return out["loss"].astype(jnp.float32)

    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jmodule.tx.init(variables["params"]), rng=key)
    state, metrics = step(state, jbatch)

    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu", **kw),
                      optimizer=OPT)
    module.load_variables(variables)
    got = Trainer(precision="bf16-mixed", seed=0).train_step(module, batch)
    assert _rel(got["loss"], metrics["loss"]) < 1e-2

    target = module.policy
    ref_grads = {k: v.numpy() for k, v in flax_to_torch(
        {"params": jgrads, "batch_stats": variables["batch_stats"]}, target).items()}
    g_max = max(np.abs(g).max() for g in ref_grads.values())
    for name, p in module.policy.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        ref = ref_grads[name]
        if np.abs(ref).max() == 0:  # off the path, or a frozen backbone
            assert not p.grad.any(), name
        elif any(k in name for k in _ZERO_GRAD):
            assert max(np.abs(ref).max(), p.grad.abs().max().item()) <= 5e-3 * g_max, name
        else:
            assert _rel(p.grad, ref) < 0.2, name

    final = flax_to_torch({"params": jax.tree.map(np.asarray, state.params),
                           "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
                          target)
    now = module.policy.state_dict()
    for name, ref in final.items():
        ref, got_now = ref.numpy(), now[name].numpy()
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got_now, ref, rtol=1e-3, atol=1e-5, err_msg=name)
            continue
        g = np.abs(ref_grads[name])
        signal = g >= 0.25 * g.max() if not any(k in name for k in _ZERO_GRAD) else g < 0
        diff = np.abs(got_now - ref)
        assert (diff[signal] <= 1e-6).all() and (diff <= 2 * LR + 1e-6).all(), name


def test_frozen_fused_route_matches_plain_chain(monkeypatch):
    """The frozen-backbone flagship's bf16 train-mode step on the port's
    fused route against its plain chain, the same weights and random
    streams: the loss equal (the two routes compute the same bf16 values and
    sum them in the same order), every gradient within 2e-2 of its tensor's
    largest entry (the factorised backward sums in f32 what autograd of the
    chain sums in bf16)."""
    eps = np.random.RandomState(1).randn(2, 32).astype(np.float32)
    _common_patches(monkeypatch, eps)
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu",
                                            freeze_backbone=True, seed=3))
    batch = _batch()
    results = []
    for fused in (False, True):
        if fused:
            _fused_route(monkeypatch)
        module.policy.zero_grad(set_to_none=True)
        out = module.forward_train(batch, module.make_rngs(0), BF16)
        out["loss"].float().backward()
        results.append((out["loss"].detach(), {n: p.grad.clone() for n, p in
                                               module.policy.named_parameters()
                                               if p.grad is not None}))
    (loss_plain, g_plain), (loss_fused, g_fused) = results
    assert torch.equal(loss_plain, loss_fused)
    assert g_plain.keys() == g_fused.keys()
    assert not any(n.startswith("backbone.") for n in g_fused)  # frozen
    for name, g in g_fused.items():
        assert _rel(g, g_plain[name].numpy()) < 2e-2, name
