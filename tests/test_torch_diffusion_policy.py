"""Parity of the port's Diffusion Policy over point clouds with the JAX
package's, on the CPU, at a tiny size (the JAX side built as
``tests/test_diffusion_policy.py`` builds it): the scheduler, the
normalizer, the mask generators, the UNet, the transposed convolution, the
point-cloud encoder, the policy's loss and gradients, its sampling chain,
the dtypes of the ``"bf16-mixed"`` step, a JAX checkpoint converted and
resumed, and the module's random streams.

Inputs come from numpy seeds; JAX variables are randomised (biases, norm
scales of both signs, running statistics) and converted with
``flax_to_torch``. Where a test needs the same random draws on both sides,
the JAX module's ``make_rng`` returns a fixed key and the port's draw
function (``training_draws``, ``sampling_noise``) returns what JAX draws
from it. Each test states its limits.
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pointcloudmatters_tpu.models.components.diffusion_policy import (
    diffusion_unet_image_policy as jdp,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion import (
    conditional_unet1d as junet,
    ddpm as jddpm,
    mask_generator as jmask,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.vision.pcd_obs_encoder import (
    PCDObsEncoder as JEncoder,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import PointNet as JPointNet
from pointcloudmatters_tpu.trainer import _cast_floating
from pointcloudmatters_tpu.utils import normalizer as jnorm
from pointcloudmatters_tpu_torch.models.bc_module import BCModule, cast_floating
from pointcloudmatters_tpu_torch.models.components.diffusion_policy import (
    diffusion_unet_image_policy as tdp,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import (
    conditional_unet1d as tunet,
    ddpm as tddpm,
    mask_generator as tmask,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.pcd_obs_encoder import (  # noqa: E501
    PCDObsEncoder,
)
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import PointNet
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.utils import normalizer as tnorm
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

META = {
    "action": {"shape": [7]},
    "obs": {"pcds": {"shape": [6], "type": "pcd"}, "qpos": {"shape": [9], "type": "low_dim"}},
    "goal": {"task_emb": {"shape": [3]}},
}
ENC = dict(n_obs_step=2, pcd_nsample=4, pcd_npoints=16, pcd_hidden_dim=32, projector_layers=1,
           projector_channels=[32, 48, 48])
POLICY = dict(horizon=8, n_action_steps=4, n_obs_steps=2, num_inference_steps=5,
              diffusion_step_embed_dim=16, down_dims=(32, 64), kernel_size=5, n_groups=8,
              cond_predict_scale=True)
SCHED = dict(num_train_timesteps=5, beta_schedule="squaredcos_cap_v2")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol, rtol=0,
                               err_msg=what)


def _scaled(ref) -> float:
    return max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _batch(B=2, To=2, N=64, horizon=8, seed=0, with_action=True):
    """``tests/test_diffusion_policy.py``'s ``_dp_batch``, numpy."""
    rng = np.random.RandomState(seed)
    out = {
        "obs": {
            "qpos": rng.randn(B, horizon, 9).astype(np.float32),
            "pcds": {
                "coord": rng.randn(B * To, N, 3).astype(np.float32),
                "feat": rng.randn(B * To, N, 6).astype(np.float32),
                "valid": np.arange(N)[None] < np.array([N - 8, N, N - 3, N] * B)[: B * To, None],
            },
        },
        "action": rng.randn(B, horizon, 7).astype(np.float32),
        "goal": {"task_emb": rng.randn(B, 3).astype(np.float32)},
    }
    if not with_action:
        del out["action"]
    return out


def _normalizers():
    """A fitted normalizer of each package (action in [5, 9], qpos normal)."""
    rng = np.random.RandomState(0)
    data = {"action": rng.uniform(5.0, 9.0, (100, 7)).astype(np.float32),
            "qpos": rng.randn(100, 9).astype(np.float32)}
    j, t = jnorm.LinearNormalizer(), tnorm.LinearNormalizer()
    j.fit(data)
    t.fit(data)
    return j, t


def _jax_policy(pre_sample=False, normalizer=None):
    enc = JEncoder(shape_meta=META, pcd_model=JPointNet(in_channels=6, num_classes=32),
                   pre_sample=pre_sample, **ENC)
    return jdp.DiffusionUnetImagePolicy(
        shape_meta=META, noise_scheduler=jddpm.DDPMScheduler(**SCHED), obs_encoder=enc,
        normalizer=normalizer, **POLICY)


def _torch_policy(pre_sample=False, normalizer=None):
    enc = PCDObsEncoder(shape_meta=META, pcd_model=PointNet(in_channels=6, num_classes=32),
                        pre_sample=pre_sample, **ENC)
    return tdp.DiffusionUnetImagePolicy(
        shape_meta=META, noise_scheduler=tddpm.DDPMScheduler(**SCHED), obs_encoder=enc,
        normalizer=normalizer, **POLICY)


def _variables(jm, *args, seed=7, **kwargs):
    """Random variables of the JAX module ``jm`` in the tree its ``init``
    makes (traced only, not compiled): kernels normal with std
    1/sqrt(fan_in), biases, norm scales (either sign) and statistics as
    ``_randomize`` draws them."""
    return _random_like(_shapes(jm, *args, **kwargs), seed)


def _shapes(jm, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "noise": key, "sample": key}
    return jax.eval_shape(lambda *a: jm.init(rngs, *a, **kwargs),
                          *jax.tree.map(jnp.asarray, args))


@functools.cache
def _policy_shapes(pre_sample: bool):
    """The tiny JAX policy's variable shapes (the same at any batch and with
    any normalizer), traced once a process: a trace takes seconds."""
    return _shapes(_jax_policy(pre_sample), _batch(), train=True)


def _policy_variables(pre_sample=False, seed=7):
    """``_variables`` of the tiny JAX policy."""
    return _random_like(_policy_shapes(pre_sample), seed)


def _random_like(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        if path[-1].key in ("kernel", "cls_embed"):
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.zeros(x.shape, np.float32)

    return jax.tree.map(np.asarray, _randomize(jax.tree_util.tree_map_with_path(leaf, shapes),
                                               seed))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return _t(tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread here, as the test processes run several at once
    beside JAX's thread pool: tiny convolutions and group norms ran 100x
    slower on all the cores. The count is restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FIXED_KEY = jax.random.PRNGKey(11)
# biases whose shift a train-mode batch norm takes out again: the PointNet
# head's (the token builder's linear, then its batch norm) and the
# projector's
ZERO_GRAD = ("obs_encoder.pcd_model.final.bias", "obs_encoder.projector_conv0.bias",
             "obs_encoder.projector_out.bias")


@pytest.fixture
def fixed_rng(monkeypatch):
    """JAX's ``make_rng`` returns FIXED_KEY; the port's draw functions
    return what JAX draws from it."""
    monkeypatch.setattr(jdp.DiffusionUnetImagePolicy, "make_rng", lambda self, name: FIXED_KEY)

    def training_draws(generator, shape, dtype, batch, num_train_timesteps):
        k_noise, k_t = jax.random.split(FIXED_KEY)
        noise = jax.random.normal(k_noise, shape, jnp.float32)
        ts = jax.random.randint(k_t, (batch,), 0, num_train_timesteps)
        return _t(noise).to(dtype), _t(ts)

    def sampling_noise(generator, shape, dtype, step):
        key, k0 = jax.random.split(FIXED_KEY)
        if step is None:
            return _t(jax.random.normal(k0, shape, jnp.float32)).to(dtype)
        return _t(jax.random.normal(jax.random.fold_in(key, step), shape)).to(dtype)

    monkeypatch.setattr(tdp, "training_draws", training_draws)
    monkeypatch.setattr(tdp, "sampling_noise", sampling_noise)


# ---------------------------------------------------------------------------
# scheduler, normalizer, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_scheduler_tables_and_grid_equal_jax(schedule):
    """The f32 tables bit-equal (the same f64 numpy computation), the
    descending inference grid equal."""
    j = jddpm.DDPMScheduler(num_train_timesteps=100, beta_schedule=schedule)
    t = tddpm.DDPMScheduler(num_train_timesteps=100, beta_schedule=schedule)
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(t._table(name), j._table(name))
    for n in (100, 10, 7):
        np.testing.assert_array_equal(t.inference_timesteps(n), j.inference_timesteps(n))


@pytest.mark.parametrize("prediction_type,clip", [("epsilon", True), ("epsilon", False),
                                                  ("sample", True)])
@pytest.mark.parametrize("t,t_prev", [(99, 89), (40, 30), (5, 0), (0, -1)])
def test_scheduler_add_noise_and_step_match_jax(prediction_type, clip, t, t_prev):
    """``add_noise`` and one reverse ``step`` (the noise gated out at t = 0)
    within 1e-6 of JAX's; a bf16 sample stays bf16."""
    kw = dict(num_train_timesteps=100, beta_schedule="squaredcos_cap_v2",
              prediction_type=prediction_type, clip_sample=clip)
    j, s = jddpm.DDPMScheduler(**kw), tddpm.DDPMScheduler(**kw)
    rng = np.random.RandomState(t)
    sample, out, noise = (rng.randn(2, 8, 7).astype(np.float32) for _ in range(3))
    ts = np.array([t, max(t_prev, 0)], np.int32)
    _close(s.add_noise(_t(sample), _t(noise), _t(ts)),
           j.add_noise(jnp.asarray(sample), jnp.asarray(noise), jnp.asarray(ts)), 1e-6)
    ref = j.step(jnp.asarray(out), jnp.int32(t), jnp.int32(t_prev), jnp.asarray(sample),
                 jnp.asarray(noise))
    _close(s.step(_t(out), t, t_prev, _t(sample), _t(noise)), ref, 1e-6)
    got = s.step(_t(out).bfloat16(), t, t_prev, _t(sample).bfloat16(), _t(noise))
    assert got.dtype == torch.bfloat16


def test_normalizer_matches_jax_on_arrays_and_tensors():
    """``normalize``/``unnormalize`` bit-equal to JAX's on numpy arrays and
    (as f32 tensors) on jnp arrays; a bf16 tensor comes out f32 as JAX's
    bf16 array does; the state dict round-trips, from numpy or tensors;
    the range, identity, image and gaussian normalizers equal JAX's."""
    j, t = _normalizers()
    x = np.random.RandomState(1).uniform(4.0, 10.0, (3, 8, 7)).astype(np.float32)
    for fn in ("normalize", "unnormalize"):
        ref_np = getattr(j["action"], fn)(x)
        np.testing.assert_array_equal(getattr(t["action"], fn)(x), ref_np)
        ref = np.asarray(getattr(j["action"], fn)(jnp.asarray(x)))
        np.testing.assert_array_equal(getattr(t["action"], fn)(_t(x)).numpy(), ref)
        bf = getattr(t["action"], fn)(_t(x).bfloat16())
        jbf = getattr(j["action"], fn)(jnp.asarray(x, jnp.bfloat16))
        assert bf.dtype == torch.float32 and jbf.dtype == jnp.float32
        np.testing.assert_array_equal(bf.numpy(), np.asarray(jbf))
    state = t.state_dict()
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(state[k]["scale"], v["scale"])
        np.testing.assert_array_equal(state[k]["offset"], v["offset"])
    back = tnorm.LinearNormalizer.from_state_dict(
        {k: {"scale": _t(v["scale"]), "offset": _t(v["offset"]),
             "input_stats": {s: _t(a) for s, a in v["input_stats"].items()}}
         for k, v in state.items()})
    np.testing.assert_array_equal(back["qpos"].normalize(x[..., :7].repeat(2, -1)[..., :9]),
                                  j["qpos"].normalize(x[..., :7].repeat(2, -1)[..., :9]))
    stat = jnorm.array_to_stats(x)
    for name in ("get_range_normalizer_from_stat", "get_identity_normalizer_from_stat"):
        got, ref = getattr(tnorm, name)(stat), getattr(jnorm, name)(stat)
        np.testing.assert_array_equal(got.scale, ref.scale)
        np.testing.assert_array_equal(got.offset, ref.offset)
    got, ref = tnorm.get_image_range_normalizer(), jnorm.get_image_range_normalizer()
    np.testing.assert_array_equal(got.offset, ref.offset)
    got = tnorm.SingleFieldLinearNormalizer.create_fit(x, mode="gaussian")
    ref = jnorm.SingleFieldLinearNormalizer.create_fit(x, mode="gaussian")
    np.testing.assert_array_equal(got.scale, ref.scale)


@pytest.mark.parametrize("obs_dim,action_visible", [(0, False), (5, False), (5, True)])
def test_lowdim_mask_generator_equals_jax(obs_dim, action_visible):
    """The fixed-step masks equal; with random steps each row's visible
    prefix has 1 .. max_n_obs_steps steps."""
    shape = (3, 6, 7 + obs_dim)
    kw = dict(action_dim=7, obs_dim=obs_dim, max_n_obs_steps=3, action_visible=action_visible)
    np.testing.assert_array_equal(tmask.LowdimMaskGenerator(**kw)(shape).numpy(),
                                  np.asarray(jmask.LowdimMaskGenerator(**kw)(shape)))
    np.testing.assert_array_equal(tmask.DummyMaskGenerator()(shape).numpy(),
                                  np.asarray(jmask.DummyMaskGenerator()(shape)))
    if obs_dim:
        gen = torch.Generator().manual_seed(0)
        mask = tmask.LowdimMaskGenerator(**dict(kw, fix_obs_steps=False))(shape, gen)
        steps = mask[:, :, 7:].all(-1).sum(-1)
        assert ((steps >= 1) & (steps <= 3)).all()


def test_keypoint_mask_generator_equals_jax_where_it_draws_nothing_that_matters():
    """All keypoints visible (rate 1) and fixed steps: the masks equal."""
    kw = dict(action_dim=4, keypoint_dim=2, max_n_obs_steps=2, keypoint_visible_rate=1.1,
              context_dim=3, action_visible=True)
    shape = (2, 5, 4 + 3 + 6)
    np.testing.assert_array_equal(
        tmask.KeypointMaskGenerator(**kw)(shape, torch.Generator().manual_seed(0)).numpy(),
        np.asarray(jmask.KeypointMaskGenerator(**kw)(shape, jax.random.PRNGKey(0))))


# ---------------------------------------------------------------------------
# the UNet and its transposed convolution
# ---------------------------------------------------------------------------

def test_conv_transpose_equals_flax():
    """flax ``ConvTranspose(4, 2, "SAME")`` against the port's
    ``Upsample1d`` (``ConvTranspose1d(4, 2, 1)`` on the kernel flipped in
    time by ``flax_to_torch``): within 1e-6."""
    x = np.random.RandomState(0).randn(2, 6, 5).astype(np.float32)  # (B, T, C)
    jm = junet.Upsample1d(5)
    variables = _variables(jm, x, seed=1)
    tm = tunet.Upsample1d(5)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    ref = jm.apply(variables, jnp.asarray(x))
    got = tm(_t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, 12, 5)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("down_dims,horizon,local", [((32, 64), 8, False),
                                                     ((16, 32, 64), 8, False),
                                                     ((32, 64), 8, True)])
def test_unet_forward_matches_jax(down_dims, horizon, local):
    """The UNet forward at two and three levels (the first skip unused), with
    the local-condition branch (its second output unused) in one case:
    within 1e-5 of max(1, max |ref|)."""
    rng = np.random.RandomState(0)
    B, G = 3, 11
    x = rng.randn(B, horizon, 7).astype(np.float32)
    cond = rng.randn(B, G).astype(np.float32)
    ts = np.array([0, 3, 97], np.int32)
    lc = rng.randn(B, horizon, 4).astype(np.float32) if local else None
    kw = dict(diffusion_step_embed_dim=16, down_dims=down_dims, kernel_size=5, n_groups=8,
              cond_predict_scale=True)
    jm = junet.ConditionalUnet1D(input_dim=7, global_cond_dim=G, **kw)
    args = (jnp.asarray(x), jnp.asarray(ts), None if lc is None else jnp.asarray(lc),
            jnp.asarray(cond))
    variables = _variables(jm, *args, seed=3)
    tm = tunet.ConditionalUnet1D(input_dim=7, local_cond_dim=4 if local else None,
                                 global_cond_dim=G, **kw)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    ref = jax.jit(jm.apply)(variables, *args)
    local_cond = None if lc is None else _t(lc)
    got = tm(_t(x), _t(ts), local_cond, _t(cond))
    _close(got, ref, 1e-5 * _scaled(ref))
    # a host timestep and a 0-d one broadcast over the batch, as in JAX
    five = tm(_t(x), torch.full((B,), 5), local_cond, _t(cond))
    assert torch.equal(tm(_t(x), 5, local_cond, _t(cond)), five)
    assert torch.equal(tm(_t(x), torch.tensor(5), local_cond, _t(cond)), five)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_sample", [False, True])
def test_encoder_matches_jax(pre_sample):
    """The encoder in train mode (batch statistics, running statistics
    updated) and in eval mode. Limits: the input of the last batch norm
    (``projector_out``) within 1e-5 of max(1, max |ref|) [5.1e-6 measured]
    and the eval features too [7e-7]; the running statistics within 1e-5.
    In train mode that batch norm normalises each channel over the 4
    clouds, and a channel of small spread magnifies its input's rounding
    gap: the train features within 1e-4 [4.2e-5]."""
    batch = _batch()
    obs = {"pcds": batch["obs"]["pcds"], "qpos": batch["obs"]["qpos"][:, :2].reshape(4, 9)}
    jm = JEncoder(shape_meta=META, pcd_model=JPointNet(in_channels=6, num_classes=32),
                  pre_sample=pre_sample, **ENC)
    jobs = jax.tree.map(jnp.asarray, obs)
    variables = _variables(jm, obs, seed=5, train=True)
    tm = PCDObsEncoder(shape_meta=META, pcd_model=PointNet(in_channels=6, num_classes=32),
                       pre_sample=pre_sample, **ENC)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    assert tm.feature_dim == 48 + 9
    ref, mut = jax.jit(lambda v, o: jm.apply(
        v, o, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "projector_out"))(variables, jobs)
    seen = {}
    tm.projector_out.register_forward_hook(lambda m, a, o: seen.update(out=o))
    got = tm(_to_torch(obs), train=True)
    inner = mut["intermediates"]["projector_out"]["__call__"][0]
    _close(seen["out"], inner, 1e-5 * _scaled(inner), "projector_out, train")
    _close(got, ref, 1e-4 * _scaled(ref), "train")
    stats = flax_to_torch({"params": variables["params"], "batch_stats": mut["batch_stats"]}, tm)
    for name, buf in tm.named_buffers():
        _close(buf, stats[name], 1e-5, name)
    ref = jax.jit(lambda v, o: jm.apply(v, o, train=False))(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]}, jobs)
    _close(tm(_to_torch(obs), train=False), ref, 1e-5 * _scaled(ref), "eval")


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def _policies(pre_sample=False, seed=7):
    """The JAX and the port's tiny policy with the same fitted normalizer
    and the same random variables."""
    jn, tn = _normalizers()
    jpolicy = _jax_policy(pre_sample, normalizer=jn)
    variables = _policy_variables(pre_sample, seed=seed)
    tpolicy = _torch_policy(pre_sample, normalizer=tn)
    tpolicy.load_state_dict(flax_to_torch(variables, tpolicy), strict=True)
    return jpolicy, tpolicy, variables


@pytest.mark.parametrize("pre_sample", [False, True])
def test_policy_loss_and_gradients_match_jax(pre_sample, fixed_rng):
    """The train-mode loss and every parameter's gradient, JAX's noise and
    timesteps on both sides, within ``tests/test_torch_training.py``'s
    limits: the loss 1e-4 relative, each gradient 1e-4 of its tensor's
    largest entry; the running statistics 1e-5. The biases in ZERO_GRAD
    have an exact gradient of 0 (a train-mode batch norm takes out the
    shift they add), as has the projector batch norm's where every pooled
    maximum passes its ReLU: there, and wherever JAX's gradient is below
    1e-6 of the model's largest entry, both sides hold rounding noise
    only, within 1e-6 of that entry. B=4 (8 clouds): at B=2 the batch
    norms' statistics over 4 rows magnify the rounding gap to 1.2e-4 of the
    token builder's bias gradient (2.2e-5 at B=4)."""
    jpolicy, tpolicy, variables = _policies(pre_sample)
    batch = _batch(B=4)

    def loss_fn(params, b):
        out, mut = jpolicy.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                                 train=True, mutable=["batch_stats"])
        return out["loss"], mut

    (loss, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jax.tree.map(jnp.asarray, batch))
    out = tpolicy(_to_torch(batch), train=True, rngs={"noise": torch.Generator()})
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss), rtol=1e-4)
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, grads),
                         "batch_stats": mut["batch_stats"]}, tpolicy)
    stats = flax_to_torch({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                          tpolicy)
    largest = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, p in tpolicy.named_parameters():
        r = ref[name].numpy()
        if name in ZERO_GRAD or np.abs(r).max() <= 1e-6 * largest:
            assert max(np.abs(r).max(), p.grad.abs().max()) <= 1e-6 * largest, name
        else:
            _close(p.grad, r, 1e-4 * np.abs(r).max(), f"d {name}")
    for name, buf in tpolicy.named_buffers():
        _close(buf, stats[name], 1e-5, name)


def test_sampling_chain_matches_jax(fixed_rng):
    """The 5-step reverse chain in eval mode from JAX's own draws (its
    initial trajectory and each step's noise): ``action_pred`` and the
    executed window within 1e-4 of max(1, max |ref|), the actions inside
    the normalizer's range (clip_sample), as JAX's are."""
    jpolicy, tpolicy, variables = _policies()
    batch = _batch(with_action=False)
    ref = jax.jit(lambda v, b: jpolicy.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    got = tpolicy(_to_torch(batch), train=False, rngs={"sample": torch.Generator()})
    assert got["action_pred"].shape == (2, 8, 7) and got["action"].shape == (2, 4, 7)
    for key in ("action_pred", "action", "a_hat"):
        _close(got[key], ref[key], 1e-4 * _scaled(ref[key]), key)
    assert torch.equal(got["action"], got["action_pred"][:, 1:5])
    a = got["action"].detach().numpy()
    assert a.min() >= 5.0 - 1e-3 and a.max() <= 9.0 + 1e-3


def test_sampling_is_reproducible_from_the_generator():
    """The same generator state gives the same actions, another seed others."""
    _, tpolicy, _ = _policies()
    batch = _to_torch(_batch(with_action=False))

    def run(seed):
        return tpolicy(batch, train=False,
                       rngs={"sample": torch.Generator().manual_seed(seed)})["action"]

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="sample"):
        tpolicy(batch, train=False)


def _jax_stage_dtypes(jpolicy, variables, batch) -> dict:
    """{module path: (input dtype, output dtype)} of every module call in
    JAX's ``"bf16-mixed"`` train step (parameters and batch cast to bf16),
    traced by ``jax.eval_shape``; and the loss's dtype under ``"loss"``."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            x = args[0] if args else None
            seen[".".join(context.module.path)] = (
                getattr(x, "dtype", None), getattr(out, "dtype", None))
        return out

    def step(params, b):
        with fnn.intercept_methods(interceptor):
            out, _ = jpolicy.apply({"params": _cast_floating(params, jnp.bfloat16),
                                    "batch_stats": variables["batch_stats"]},
                                   _cast_floating(b, jnp.bfloat16), train=True,
                                   rngs={"noise": FIXED_KEY}, mutable=["batch_stats"])
        return out["loss"]

    seen["loss"] = (None, jax.eval_shape(step, variables["params"],
                                         jax.tree.map(jnp.asarray, batch)).dtype)
    return seen


@pytest.mark.parametrize("pre_sample", [False, True])
def test_bf16_step_stage_dtypes_equal_jax(pre_sample):
    """In the ``"bf16-mixed"`` step every module that both packages have
    takes and gives the element types JAX's does: the encoder bf16 up to
    the concatenation with the normalized (f32) qpos, the condition, the
    trajectory and every UNet layer f32 on bf16 weights, the loss f32."""
    jpolicy, tpolicy, variables = _policies(pre_sample)
    batch = _batch()
    ref = _jax_stage_dtypes(jpolicy, variables, batch)
    seen = {}
    names = {m: n for n, m in tpolicy.named_modules()}

    def hook(module, args, out):
        x = args[0] if args else None
        seen[names[module]] = (getattr(x, "dtype", None), getattr(out, "dtype", None))

    for m in names:
        m.register_forward_hook(hook)
    module = BCModule(tpolicy, device="cpu")
    module.train_rng_streams = ManiSkill2DiffusionPolicyBCModule.train_rng_streams
    out = module.forward_train(copy.deepcopy(batch), module.make_rngs(0), torch.bfloat16)
    seen["loss"] = (None, out["loss"].dtype)

    def name(dtype):
        return None if dtype is None else str(dtype).split(".")[-1]

    common = sorted(set(ref) & set(seen))
    assert len(common) > 60 and {"model", "obs_encoder", "model.down0_res0.block0.norm",
                                 "model.up0_us", "obs_encoder.bn", "loss"} <= set(common)
    differ = {k: (ref[k], seen[k]) for k in common
              if (name(ref[k][0]), name(ref[k][1])) != tuple(map(name, seen[k]))
              and not (ref[k][0] is None or seen[k][0] is None)
              or name(ref[k][1]) != name(seen[k][1])}
    assert not differ, differ
    assert name(seen["model"][0]) == "float32" and name(seen["obs_encoder.pcd_model"][1]) \
        == "bfloat16" and name(seen["loss"][1]) == "float32"


def test_module_streams_and_eval():
    """The DP module's streams: ``"noise"`` each rank's own under data
    parallelism, ``"dropout"`` shared; in a world of one the single-device
    set. Its held-out loss draws from streams seeded 0 for every batch, so
    two evaluations agree; ``predict`` draws from the generator given."""
    _, tpolicy, _ = _policies()
    module = ManiSkill2DiffusionPolicyBCModule(tpolicy, device="cpu")
    assert set(module.make_rngs(0)) == {"noise", "dropout", "crop", "mask", "bits"}

    def draw(rngs, name):
        return torch.randn(4, generator=rngs[name])

    ranks = [module.make_rngs(0, rank=r, world_size=2) for r in (0, 1)]
    assert not torch.equal(draw(ranks[0], "noise"), draw(ranks[1], "noise"))
    assert torch.equal(draw(ranks[0], "dropout"), draw(ranks[1], "dropout"))
    batch = _batch()
    assert torch.equal(module.apply_eval(batch)["loss"], module.apply_eval(batch)["loss"])
    obs = _batch(with_action=False)
    a = module.predict(obs, torch.Generator().manual_seed(1))
    assert a.shape == (2, 4, 7)
    assert torch.equal(a, module.predict(obs, torch.Generator().manual_seed(1)))


# ---------------------------------------------------------------------------
# a JAX checkpoint, converted and resumed
# ---------------------------------------------------------------------------

def test_resume_from_a_converted_jax_checkpoint_matches_jax(tmp_path, fixed_rng):
    """A JAX DP checkpoint (Orbax, written by the JAX trainer: random
    weights, running statistics and AdamW moments, 3 steps into a OneCycleLR
    schedule, the normalizer in its extras) converted by
    ``jax_checkpoint_to_torch`` and restored into a fresh port module with
    other weights, then one training step, against JAX's own restore and
    step, within ``tests/test_torch_checkpoint.py``'s limits: the loss 1e-4
    relative; parameters 2e-6 + 1e-4 of a tensor's largest entry; AdamW's
    moments 1e-6 + 1e-3 and its step count equal; the schedule's step
    equal; running statistics 1e-5; the normalizer bit-equal."""
    import orbax.checkpoint as ocp

    from pointcloudmatters_tpu.models.maniskill2_modules import (
        ManiSkill2DiffusionPolicyBCModule as JDPModule,
    )
    from pointcloudmatters_tpu.trainer import Trainer as JTrainer, TrainState
    from pointcloudmatters_tpu_torch.trainer import Trainer, write_checkpoint
    from pointcloudmatters_tpu_torch.utils.flax_to_torch import jax_checkpoint_to_torch

    opt = {"type": "AdamW", "betas": [0.9, 0.95], "lr": 1e-3, "weight_decay": 1e-4}
    sched = {"scheduler": {"type": "OneCycleLR", "max_lr": 1e-3, "pct_start": 0.15,
                           "anneal_strategy": "cos", "div_factor": 100.0,
                           "final_div_factor": 1000.0}}
    total, done = 10, 3
    jn, _ = _normalizers()
    batch = _batch(B=4)
    variables = _policy_variables(seed=9)
    rng = np.random.RandomState(4)

    def moments(path, x):
        names = {getattr(k, "name", None) for k in path}
        name = "mu" if "mu" in names else "nu" if "nu" in names else None
        # second moments above the step's squared gradients, as after a
        # few steps, so that no entry's update hangs on a near-zero one
        if name == "mu":
            return (rng.randn(*x.shape) * 1e-2).astype(np.float32)
        if name == "nu":
            return rng.uniform(1e-2, 2e-2, x.shape).astype(np.float32)
        return np.asarray(x) + done if "count" in names else x

    def jax_side():
        module = JDPModule(_jax_policy(normalizer=jn), optimizer=opt, lr_scheduler=sched)
        module._extras["normalizer"] = jn.state_dict()
        module.configure_optimizers(variables["params"], total_steps=total)
        trainer = JTrainer(default_root_dir=str(tmp_path), precision="32-true",
                           prng_impl=None)
        trainer._module = module
        return module, trainer

    jmodule, jtrainer = jax_side()
    opt_state = jax.tree_util.tree_map_with_path(moments,
                                                 jmodule.tx.init(variables["params"]))
    jtrainer.state = TrainState(step=jnp.asarray(done, jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=opt_state,
                                rng=jax.random.PRNGKey(0))
    jtrainer.save_checkpoint(str(tmp_path / "jax_ckpt"))

    # JAX's own resume: a fresh trainer restores and steps
    jmodule, jresume = jax_side()
    jmodule.policy = jmodule.policy.clone(normalizer=None)
    jresume.state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=jmodule.tx.init(variables["params"]),
                               rng=jax.random.PRNGKey(0))
    jresume.restore_checkpoint(str(tmp_path / "jax_ckpt"))
    assert jmodule.policy.normalizer is not None
    state, metrics = jresume._build_train_step(jmodule)(jresume.state,
                                                       jax.tree.map(jnp.asarray, batch))

    # the port: the same checkpoint converted, restored into other weights
    def port_module(seed):
        policy = _torch_policy()
        policy.load_state_dict(flax_to_torch(_policy_variables(seed=seed), policy))
        return ManiSkill2DiffusionPolicyBCModule(policy, optimizer=opt, lr_scheduler=sched)

    template = port_module(1)
    Trainer(accelerator="cpu").setup(template, total)
    raw = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax_ckpt"))
    converted = jax_checkpoint_to_torch(raw, template)
    assert converted["opt_state"]["scheduler"] == {"last_epoch": done}
    assert isinstance(converted["extras"]["normalizer"]["action"]["scale"], torch.Tensor)
    write_checkpoint(str(tmp_path / "port_ckpt"), converted)
    module = port_module(2)
    trainer = Trainer(accelerator="cpu", seed=0)
    trainer.setup(module, total)
    trainer.restore_checkpoint(str(tmp_path / "port_ckpt"), module)
    for key in ("action", "qpos"):
        np.testing.assert_array_equal(module.policy.normalizer[key].scale, jn[key].scale)
        np.testing.assert_array_equal(module.policy.normalizer[key].offset, jn[key].offset)
    got = trainer.train_step(module, _to_torch(batch))

    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-4)
    assert module.scheduler.last_epoch == done + 1
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, state.params),
                         "batch_stats": jax.tree.map(np.asarray, state.batch_stats)},
                        module.policy)
    sd = module.policy.state_dict()
    for name, r in ref.items():
        r = r.numpy()
        atol = 1e-5 if name.endswith((".mean", ".var")) else 2e-6 + 1e-4 * np.abs(r).max()
        _close(sd[name], r, atol, name)
    ref_opt = jax_checkpoint_to_torch(
        {"params": state.params, "batch_stats": state.batch_stats,
         "opt_state": state.opt_state, "step": 0, "epoch": 0},
        module)["opt_state"]["optimizer"]["state"]
    params = module.optimizer.param_groups[0]["params"]
    for i, (name, _) in enumerate(module.policy.named_parameters()):
        st = module.optimizer.state[params[i]]
        assert float(st["step"]) == float(ref_opt[i]["step"]) == done + 1
        for key in ("exp_avg", "exp_avg_sq"):
            r = ref_opt[i][key].numpy()
            _close(st[key], r, 1e-6 + 1e-3 * np.abs(r).max(), f"{name} {key}")
