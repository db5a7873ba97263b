"""ACT over images in the port against the JAX package, on the CPU: the
policy of the image configs (``configs/model/maniskill2_act_model.yaml``:
the 2-D sine position embedding, one camera) over each backbone at tiny
widths (``tests/test_torch_img_encoders.py``'s: ResNet-18 at 32 pixels, the
ViT of width 32, the MultiViT of width 32) and a small ACT head, on
24-pixel images from ``entry.build_image_batch``, with JAX's variables
carried over by ``flax_to_torch`` and the posterior noise fixed to one
numpy array on both sides.

- ``predict`` within 1e-5 of the largest action;
- five f32 SGD steps of the port's ``Trainer.train_step`` against five of
  the JAX module's ``apply_train`` gradient (one compile), each step's loss
  within 1e-4 relative, the parameters and batch statistics after them
  within 2e-6 + 1e-4 of each tensor's largest entry, every backbone
  trained (not frozen). JAX's own ResNet trajectory depends on the order
  of the batch where a ReLU input lies within the rounding of its f32
  batch statistics of zero (``tests/test_torch_img_encoders.py``), so for
  ResNet JAX runs the batches of seeds 1 and 2 in their order and
  reversed: the port must match both trajectories where they agree and one
  where they do not, and one batch must be of the first kind;
- the ``"bf16-mixed"`` step's loss within 1e-2 relative and every gradient
  within 5e-2 · max(1, max|g|), max|g| the model's largest entry (the
  SpUNet step's limit: a convolution under a batch norm gets its gradient
  as the rest of a cancellation, which bf16 rounds to noise);
- the bf16 step's stage types: every module both packages have takes and
  gives JAX's element types (``flax.linen.intercept_methods``), the loss
  included;
- in the port alone: a ViT that masks as MAE's draws from the step's
  ``"mask"`` stream (the ``"vae"`` generator), and a frozen backbone gets no gradient while its
  statistics move.

The ResNet batches hold 8 images (its last stage is 1 x 1: a batch norm
over 2 values magnifies rounding), the others 2.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act import positional_encoding as jpe
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.trainer import _cast_floating
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_img_encoders import (  # noqa: F401
    IMG,
    MULTIVIT,
    TINY_VIT,
    backbones,
    init_variables,
    one_torch_thread,
    tiny_vit_arch,
)

HEAD = dict(hidden_dim=32, chunk=5, enc_layers=1, dec_layers=2, nhead=4)
SGD = {"type": "SGD", "lr": 1e-3}
N_STEPS = 5
CASES = {"resnet": 3, "vit": 3, "multivit": 4}  # backbone -> channels
RESNET_BATCH_SEEDS = (1, 2)  # batches whose f32 trajectory runs in both orders


def _jax_act(kind: str):
    d = HEAD["hidden_dim"]
    jnet, _ = backbones(kind, CASES[kind])
    return jact.ACT(
        backbone=jnet,
        transformer=JTransformer(
            d_model=d, nhead=HEAD["nhead"], num_encoder_layers=HEAD["enc_layers"],
            num_decoder_layers=HEAD["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=HEAD["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=HEAD["chunk"], num_cameras=1, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0,
        obs_feature_pos_embedding=jpe.PositionEmbeddingSine(num_pos_feats=d // 2,
                                                            normalize=True))


def _port_act(kind: str, freeze: bool = False):
    kw = {"resnet": dict(resnet_model="resnet18", resize_to=32),
          "vit": dict(model_name=TINY_VIT, img_size=32), "multivit": MULTIVIT}[kind]
    return tentry.build_image_policy(kind, CASES[kind], **HEAD, dropout=0.0, backbone_kw=kw,
                                     freeze_backbone=freeze, device="cpu")


def _batch(kind: str, with_actions: bool = True, seed: int = 1) -> dict:
    batch = tentry.build_image_batch(8 if kind == "resnet" else 2, IMG, CASES[kind],
                                     chunk=HEAD["chunk"], seed=seed, with_actions=with_actions)
    if with_actions:
        batch["is_pad"] = np.arange(HEAD["chunk"])[None] >= np.arange(3, 3 + len(batch["qpos"])
                                                                      )[:, None] % 6
    return batch


@pytest.fixture(scope="module", params=list(CASES))
def act_case(request, tiny_vit_arch):  # noqa: F811
    """JAX's variables, the f32 SGD trajectories (5 steps of its
    ``apply_train`` gradient, one compile: for ResNet of each batch of
    ``RESNET_BATCH_SEEDS`` in its order and reversed), the bf16 gradients
    and the f32 ``predict`` of ACT over one backbone; the posterior noise
    fixed."""
    kind = request.param
    batch = _batch(kind)
    eps = np.random.RandomState(0).randn(len(batch["qpos"]), 32).astype(np.float32)
    jpolicy = _jax_act(kind)
    jbatch = jax.tree.map(jnp.asarray, batch)
    variables = init_variables(jpolicy, jbatch, seed=7)
    variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
    noise = {}  # the posterior noise of the step being traced
    saved = jact.reparametrize
    jact.reparametrize = lambda mu, logvar, k: mu + jnp.exp(0.5 * logvar) * noise["eps"].astype(
        mu.dtype)
    try:
        with jax.default_prng_impl("threefry2x32"):
            jmodule = JBCModule(jpolicy, optimizer=SGD)
            rngs = jmodule.make_rngs(jax.random.PRNGKey(0))

        def loss_fn(params, stats, b, e, dtype):
            noise["eps"] = e
            out, mut = jmodule.apply_train(
                {"params": _cast_floating(params, dtype), "batch_stats": stats},
                _cast_floating(b, dtype), rngs=rngs)
            return out["loss"].astype(jnp.float32), mut.get("batch_stats", {})

        grad_fn = {dt: jax.jit(jax.value_and_grad(lambda p, s, b, e, d=dt: loss_fn(p, s, b, e, d),
                                                  has_aux=True))
                   for dt in (jnp.float32, jnp.bfloat16)}

        def trajectory(b, e):
            params, stats = variables["params"], variables["batch_stats"]
            losses = []
            for _ in range(N_STEPS):
                (loss, stats), grads = grad_fn[jnp.float32](params, stats, b, e)
                losses.append(float(loss))
                params = jax.tree.map(lambda p, g: np.asarray(p - SGD["lr"] * g), params, grads)
            return losses, {"params": jax.tree.map(np.asarray, params),
                            "batch_stats": jax.tree.map(np.asarray, stats)}

        runs = {}
        for seed in (RESNET_BATCH_SEEDS if kind == "resnet" else (1,)):
            b = _batch(kind, seed=seed)
            runs[seed] = [trajectory(jax.tree.map(jnp.asarray, b), eps)]
            if kind == "resnet":
                runs[seed].append(trajectory(jax.tree.map(lambda a: jnp.asarray(a[::-1]), b),
                                             eps[::-1]))
        (bf16_loss, _), bf16_grads = grad_fn[jnp.bfloat16](
            variables["params"], variables["batch_stats"], jbatch, eps)
        request_batch = _batch(kind, with_actions=False)
        a_hat = np.asarray(jax.jit(lambda v, b: jpolicy.apply(v, b, train=False)["a_hat"])(
            variables, jax.tree.map(jnp.asarray, request_batch)))
        noise["eps"] = jnp.asarray(eps)
        dtypes = _jax_stage_dtypes(jpolicy, variables, jbatch, rngs)
    finally:
        jact.reparametrize = saved
    return dict(kind=kind, batch=batch, eps=eps, variables=variables,
                runs=runs, bf16=(float(bf16_loss), jax.tree.map(np.asarray, bf16_grads)),
                request=request_batch, a_hat=a_hat, dtypes=dtypes)


def _jax_stage_dtypes(jpolicy, variables, jbatch, rngs) -> dict:
    """{module path: (input dtype, output dtype)} of every module call in
    JAX's ``"bf16-mixed"`` train step, traced by ``jax.eval_shape``."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            x = args[0] if args else None
            seen[".".join(context.module.path)] = (getattr(x, "dtype", None),
                                                    getattr(out, "dtype", None))
        return out

    def step(params):
        with fnn.intercept_methods(interceptor):
            out, _ = jpolicy.apply({"params": _cast_floating(params, jnp.bfloat16),
                                    "batch_stats": variables["batch_stats"]},
                                   _cast_floating(jbatch, jnp.bfloat16), train=True, rngs=rngs,
                                   mutable=["batch_stats"])
        return out["loss"]

    seen["loss"] = (None, jax.eval_shape(step, variables["params"]).dtype)
    return seen


def _module(case, monkeypatch):
    eps = case["eps"]
    monkeypatch.setattr(tact, "reparametrize", lambda mu, logvar, gen: (
        mu + torch.exp(0.5 * logvar) * torch.from_numpy(eps).to(mu.dtype)))
    module = BCModule(_port_act(case["kind"]), optimizer=SGD)
    module.load_variables(case["variables"])
    return module


def test_act_image_predict_matches_jax(act_case, monkeypatch):
    module = _module(act_case, monkeypatch)
    a_hat = module.predict(act_case["request"])
    ref = act_case["a_hat"]
    np.testing.assert_allclose(a_hat.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _trajectory_excess(losses, state, ref) -> tuple:
    """(largest error over its limit, what): the losses within 1e-4
    relative, every parameter and statistic within 2e-6 + 1e-4 of its
    tensor's largest entry; at most 1 where all are within."""
    ref_losses, ref_final = ref
    worst = max((abs(a - b) / (1e-4 * abs(b)), f"loss {i}")
                for i, (a, b) in enumerate(zip(losses, ref_losses)))
    for name, r in ref_final.items():
        r = r.numpy()
        worst = max(worst, (np.abs(state[name].numpy() - r).max() / (2e-6 + 1e-4 * np.abs(r).max()),
                            name))
    return worst


def test_act_image_f32_sgd_steps_match_jax(act_case, monkeypatch):
    """Five f32 SGD steps against JAX's trajectory of the same batch; for
    ResNet of each batch of ``RESNET_BATCH_SEEDS``, against JAX's in both
    orders where they agree and one of them where they do not (module
    doc)."""
    agreed = 0
    for seed, runs in act_case["runs"].items():
        module = _module(act_case, monkeypatch)
        trainer = Trainer(precision="32-true", seed=0)
        batch = _batch(act_case["kind"], seed=seed)
        losses = [float(trainer.train_step(module, copy.deepcopy(batch))["loss"])
                  for _ in range(N_STEPS)]
        now = module.policy.state_dict()
        refs = [(ref_losses, flax_to_torch(final, module.policy)) for ref_losses, final in runs]
        gaps = [_trajectory_excess(losses, now, ref) for ref in refs]
        if len(refs) == 1 or _trajectory_excess(refs[1][0], refs[1][1], refs[0])[0] <= 1:
            agreed += 1
            assert max(gaps)[0] <= 1, (seed, gaps)
        else:
            assert min(gaps)[0] <= 1, (seed, gaps)
        start = flax_to_torch(act_case["variables"], module.policy)
        final = refs[0][1]
        assert sum(not torch.equal(final[k], start[k]) for k in final) > len(final) // 2
        assert all(p.grad is not None and p.grad.any()
                   for p in module.policy.backbone.parameters())
    assert agreed > 0


def test_act_image_bf16_step_matches_jax(act_case, monkeypatch):
    module = _module(act_case, monkeypatch)
    got = Trainer(precision="bf16-mixed", seed=0).train_step(module, act_case["batch"])
    loss, grads = act_case["bf16"]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-2)
    ref_grads = flax_to_torch({"params": grads,
                               "batch_stats": act_case["variables"]["batch_stats"]},
                              module.policy)
    limit = 5e-2 * max(1.0, max(np.abs(g.numpy()).max() for g in ref_grads.values()))
    for name, p in module.policy.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), rtol=0, atol=limit,
                                   err_msg=name)


def test_act_image_bf16_stage_dtypes_equal_jax(act_case):
    """In the ``"bf16-mixed"`` step every module both packages have takes
    and gives the element types JAX's does (the backbone, its batch norms,
    blocks and attention, ``input_proj``, the transformer, the heads, the
    loss: bf16 throughout, the trainer takes it in f32)."""
    tpolicy = _port_act(act_case["kind"])
    seen = {}
    names = {m: n for n, m in tpolicy.named_modules()}

    def hook(module, args, out):
        x = args[0] if args else None
        seen[names[module]] = (getattr(x, "dtype", None), getattr(out, "dtype", None))

    for m in names:
        m.register_forward_hook(hook)
    module = BCModule(tpolicy, device="cpu")
    out = module.forward_train(copy.deepcopy(act_case["batch"]), module.make_rngs(0),
                               torch.bfloat16)
    seen["loss"] = (None, out["loss"].dtype)
    ref = act_case["dtypes"]

    def name(dtype):
        return None if dtype is None else str(dtype).split(".")[-1]

    common = sorted(set(ref) & set(seen))
    assert {"backbone", "input_proj", "transformer", "action_head", "loss"} <= set(common)
    assert len(common) > 20
    differ = {k: (ref[k], seen[k]) for k in common
              if name(ref[k][1]) != name(seen[k][1])
              or (ref[k][0] is not None and seen[k][0] is not None
                  and name(ref[k][0]) != name(seen[k][0]))}
    assert not differ, differ
    assert name(seen["backbone"][1]) == "bfloat16"


def test_act_over_mae_draws_its_mask_from_the_step_rngs(tiny_vit_arch):  # noqa: F811
    """ACT over a ViT that masks as MAE's does (75%) trains on the step's
    ``"mask"`` stream (ACT's module hands it the ``"vae"`` generator): the
    backbone keeps 4 of its 16 patch tokens, the same streams draw the same
    mask, and another ``"mask"`` generator alone changes the loss."""
    policy = tentry.build_image_policy(
        "vit", 3, **HEAD, dropout=0.0, device="cpu",
        backbone_kw=dict(model_name=TINY_VIT, img_size=32, mask_ratio=0.75))
    assert policy.backbone.masks_tokens
    module = BCModule(policy, device="cpu")
    tokens = []
    policy.backbone.model.blocks_0.register_forward_hook(
        lambda m, a, out: tokens.append(out.shape[1]))
    batch = _batch("vit")
    rngs = module.make_rngs(0)
    assert rngs["mask"] is rngs["vae"]
    other = dict(module.make_rngs(0), mask=torch.Generator().manual_seed(99))
    losses = [float(module.forward_train(copy.deepcopy(batch), rngs)["loss"])
              for rngs in (module.make_rngs(0), module.make_rngs(0), other)]
    assert tokens == [5, 5, 5]
    assert losses[0] == losses[1] != losses[2]


def test_act_image_frozen_backbone_gets_no_gradient_but_trains_its_statistics():
    """``freeze_backbone`` (``pretrained_r3m_rgb``, ``pretrained_vc1_rgb``)
    detaches the features: the same loss as the trained backbone's, the
    same gradients everywhere else, none in the backbone, whose batch
    statistics still move in training (JAX's ``stop_gradient``)."""
    batch = _batch("resnet")
    runs = []
    for freeze in (False, True):
        module = BCModule(_port_act("resnet", freeze), device="cpu")
        before = {k: v.clone() for k, v in module.policy.backbone.state_dict().items()}
        out = module.forward_train(copy.deepcopy(batch), module.make_rngs(0))
        out["loss"].backward()
        moved = [k for k, v in module.policy.backbone.state_dict().items()
                 if not torch.equal(v, before[k])]
        runs.append((out["loss"].item(), module.policy, moved))
    (trained_loss, trained, trained_moved), (frozen_loss, frozen, frozen_moved) = runs
    assert frozen_loss == trained_loss
    assert frozen_moved == trained_moved and len(frozen_moved) == 2 * 20
    for (name, p), q in zip(frozen.named_parameters(), trained.parameters()):
        if name.startswith("backbone."):
            assert p.grad is None and q.grad is not None and q.grad.any(), name
        else:
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0, msg=name)
