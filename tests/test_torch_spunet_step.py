"""ACT over SpUNet in the port against the JAX package, on the CPU: the
port's ``Trainer.train_step`` against the JAX module's ``apply_train``
(what the JAX ``Trainer``'s step differentiates) and ``predict``, at
``tests/test_spunet.py``'s ``TINY`` SpUNet widths and a small ACT head, on
grid-sampled clouds of 200-256 points (``entry.build_grid_batch``), with
JAX's variables carried over by ``flax_to_torch``.

Limits: the f32 step's loss within 1e-4 relative, its gradients within
1e-3 of each tensor's largest entry (the transformer's tensors whose exact
gradient is zero are held as ``tests/test_torch_training.py`` holds them),
the batch statistics after it within 1e-5 + 1e-4 of their largest entry;
``predict`` within 1e-5 of the largest action; the ``"bf16-mixed"`` step's
loss within 1e-2 relative and each gradient within 5e-2 · max(1, max|g|) of
the model's largest entry (the test says why not of each tensor's). The
JAX side compiles once for each of init, the f32 and bf16 gradients and
predict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.models.components.pcd_encoder import spunet as jspunet
from pointcloudmatters_tpu.trainer import _cast_floating
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_spunet import TINY
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

TINY_KW = {k: tuple(v) if isinstance(v, tuple) else v for k, v in TINY.items()}


def _close(got, ref, limit, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=limit * max(1e-30, np.abs(ref).max()),
                               err_msg=what)


DIMS = dict(hidden_dim=32, npoints=16, nsample=4, chunk=5, enc_layers=1, dec_layers=2,
            nhead=4)
OPT = {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05}
_ZERO_GRAD = ("self_attn.key.bias", "multihead_attn.key.bias",
              "decoder.layers.0.self_attn.query.", "decoder.layers.0.self_attn.key.")


def _jax_act(pre_sample=False):
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=jspunet.SpUNet(in_channels=6, num_classes=d if pre_sample else 0, **TINY),
        transformer=JTransformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"], pre_sample=pre_sample)


@pytest.fixture(scope="module")
def act_case():
    """The batch (grid-sampled clouds of 200-256 points), JAX's randomised
    variables and, through ``BCModule.apply_train`` (what the JAX
    ``Trainer``'s step differentiates), the f32 and bf16 steps' loss,
    gradients and batch statistics, and the f32 ``predict``; the posterior
    noise fixed, JAX's FPS and kNN given f32 coordinates (as
    ``tests/test_torch_bf16.py`` gives them). One compile each."""
    with jax.default_prng_impl("threefry2x32"):
        return _act_reference()


def _act_reference():
    batch = tentry.build_grid_batch(2, n_points=256, valid_range=(200, 256), chunk=DIMS["chunk"],
                                    side=20, seed=1)
    batch["is_pad"] = np.arange(DIMS["chunk"])[None] >= np.array([[5], [3]])
    eps = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jpolicy = _jax_act()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(jbatch)
    variables = jax.tree.map(np.asarray, _randomize(variables, 7))
    saved = (jact.reparametrize, jact.farthest_point_sampling_padded, jact.knn_query_padded)
    fps, knn, f32 = saved[1], saved[2], jnp.float32
    jact.reparametrize = lambda mu, logvar, k: mu + jnp.exp(0.5 * logvar) * jnp.asarray(
        eps, mu.dtype)
    jact.farthest_point_sampling_padded = lambda xyz, mask, n: fps(xyz.astype(f32), mask, n)
    jact.knn_query_padded = lambda q, xyz, mask, k: knn(q.astype(f32), xyz.astype(f32), mask, k)
    try:
        jmodule = JBCModule(jpolicy, optimizer=OPT)

        def loss_fn(params, dtype):
            out, mut = jmodule.apply_train(
                {"params": _cast_floating(params, dtype), "batch_stats": variables["batch_stats"]},
                _cast_floating(jbatch, dtype), rngs=jmodule.make_rngs(key))
            return out["loss"].astype(jnp.float32), mut["batch_stats"]

        steps = {}
        for dtype in (jnp.float32, jnp.bfloat16):
            (loss, stats), grads = jax.jit(jax.value_and_grad(
                lambda p, dt=dtype: loss_fn(p, dt), has_aux=True))(variables["params"])
            steps[jnp.dtype(dtype).name] = (float(loss), jax.tree.map(np.asarray, grads),
                                            jax.tree.map(np.asarray, stats))
        request = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
        a_hat = np.asarray(jax.jit(lambda v, b: jpolicy.apply(v, b, train=False)["a_hat"])(
            variables, jax.tree.map(jnp.asarray, request)))
    finally:
        jact.reparametrize, jact.farthest_point_sampling_padded, jact.knn_query_padded = saved
    return dict(batch=batch, eps=eps, variables=variables, steps=steps, a_hat=a_hat,
                request=request)


def _act_module(act_case, monkeypatch):
    eps = act_case["eps"]
    monkeypatch.setattr(tact, "reparametrize", lambda mu, logvar, gen: (
        mu + torch.exp(0.5 * logvar) * torch.from_numpy(eps).to(mu.dtype)))
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, backbone="spunet",
                                            spunet=TINY_KW, device="cpu"), optimizer=OPT)
    module.load_variables(act_case["variables"])
    return module


def _zero_grad_case(name, ref, got, limit):
    if np.abs(ref).max() == 0:
        assert not got.any(), name  # unselected branches, other conditions' embeddings
        return True
    if any(k in name for k in _ZERO_GRAD):
        assert max(np.abs(ref).max(), got.abs().max().item()) <= limit, name
        return True
    return False


def test_act_spunet_f32_step_matches_jax(act_case, monkeypatch):
    module = _act_module(act_case, monkeypatch)
    got = Trainer(precision="32-true", seed=0).train_step(module, act_case["batch"])
    loss, grads, stats = act_case["steps"]["float32"]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-4)
    ref_grads = flax_to_torch({"params": grads,
                               "batch_stats": act_case["variables"]["batch_stats"]},
                              module.policy)
    for name, p in module.policy.named_parameters():
        ref = ref_grads[name].numpy()
        if not _zero_grad_case(name, ref, p.grad, 1e-5):
            _close(p.grad, ref, 1e-3, f"grad {name}")
    final = flax_to_torch({"params": act_case["variables"]["params"], "batch_stats": stats},
                          module.policy)
    now = module.policy.state_dict()
    for name, ref in final.items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(now[name].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5 + 1e-4 * ref.abs().max().item(), err_msg=name)


def test_act_spunet_predict_matches_jax(act_case, monkeypatch):
    module = _act_module(act_case, monkeypatch)
    a_hat = module.predict(act_case["request"])
    _close(a_hat, act_case["a_hat"], 1e-5)


def test_act_spunet_bf16_step_matches_jax(act_case, monkeypatch):
    """The ``"bf16-mixed"`` step: the loss within 1e-2 relative, every
    gradient within 5e-2 · max(1, max|g|), max|g| the largest entry of the
    model's JAX bf16 gradient. Not of each tensor's: a convolution under a
    batch norm gets its gradient as the small rest of a cancellation (the
    norm is scale-invariant), which bf16 rounds to noise; JAX's own bf16
    gradient of SpUNet's tensors is 0.3-1.4 of their largest entry away
    from its f32 gradient on this batch, and the port's bf16 gradient is as
    far from either (the f32 step holds the arithmetic)."""
    module = _act_module(act_case, monkeypatch)
    got = Trainer(precision="bf16-mixed", seed=0).train_step(module, act_case["batch"])
    loss, grads, _ = act_case["steps"]["bfloat16"]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-2)
    ref_grads = flax_to_torch({"params": grads,
                               "batch_stats": act_case["variables"]["batch_stats"]},
                              module.policy)
    limit = 5e-2 * max(1.0, max(np.abs(g.numpy()).max() for g in ref_grads.values()))
    for name, p in module.policy.named_parameters():
        assert p.grad.dtype == torch.float32, name
        ref = ref_grads[name].numpy()
        if np.abs(ref).max() == 0:
            assert not p.grad.any(), name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=limit, err_msg=name)
