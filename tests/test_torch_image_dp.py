"""The image Diffusion Policy of the port against the JAX package's, on the
CPU, at tiny widths: ``MultiImageObsEncoder`` over ``tests/test_torch_img_encoders.py``'s
backbones (ResNet-18 resizing to 32, pooled; the ViT of ``img_size`` 32,
patch 8, depth 2, width 32; the MultiViT of width 32, depth 2), resizing
24-pixel images to 40 and centre-cropping 32, then a UNet of ``down_dims``
(16, 32) and a 5-step DDPM, as ``entry.build_image_dp_policy`` builds it.

Inputs come from numpy seeds (``entry.build_image_dp_batch``); JAX's
variables are randomised (biases, norm scales of either sign, running
statistics) and carried over by ``flax_to_torch``; each encoder case
compiles JAX once.

- The encoder, shared and per key, on RGB, RGB-D, depth-only, pointmap and
  two cameras: ``feature_dim`` equal to the width JAX's ``init`` gives; the
  eval features within 1e-5 · max(1, max|JAX|); in training (batch
  statistics) the features within 1e-4 · max(1, max|JAX|), the running
  statistics after them within 1e-5, and every gradient of a fixed
  cotangent within 1e-4 · max(1, max|g|) of its tensor. ResNet's
  train-mode gradients are held against JAX's for the rows in their order
  and reversed in f64 (RGB-D, shared and per key, and RGB shared by two
  cameras; the depth-only and pointmap cases differ from RGB-D in the
  stem's input width alone and check features and statistics), both
  packages' batch norms summing in f64
  (``tests/test_torch_img_encoders.py``'s ``f64_statistics``), within
  1e-8 · max(1, max|g|): in f32 the order of a statistic's sum routes a
  ReLU input within its rounding of zero (the test says more). There the
  encoders resize 24 -> 48: the port builds the resize's weights in f32
  for every image type, JAX under x64 in f64, and at 24 -> 40 the two
  sets of weights place the samples 1.6e-6 apart (without x64 the
  resizes agree within 6e-8).
- The crops: ``center_crop`` and ``CropRandomizer`` (``crop_image_from_indices``,
  ``forward_in`` at eval with ``pos_enc`` and several crops, in training
  with JAX's offsets patched in, ``forward_out``) bit-equal; the encoder's
  random crops with JAX's offsets patched in within the eval limit; the
  draws' ranges (the encoder's include ``H - h``, ``CropRandomizer``'s
  exclude it, as in JAX) and streams (``"crop"``, ``"dropout"``).
- The policy with JAX's draws patched in (``tests/test_torch_diffusion_policy.py``'s
  ``fixed_rng``): the train-mode loss within 1e-4 relative; the gradients
  within 1e-4 of each tensor's largest entry (over ResNet with its batch
  norms at their running statistics, where no ReLU input routes by a
  statistic's rounding); the 5-step sampling chain within 1e-4 ·
  max(1, max|JAX|).
- The ``"bf16-mixed"`` step's stage types, with the dataset's normalizer
  (images f32: the backbone runs f32 on bf16 weights) and without (bf16):
  every module both packages have takes and gives JAX's element types.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.components.diffusion_policy import (
    diffusion_unet_image_policy as jdp,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion import ddpm as jddpm
from pointcloudmatters_tpu.models.components.diffusion_policy.vision import (
    crop_randomizer as jcrop,
    multi_image_obs_encoder as jmio,
)
from pointcloudmatters_tpu.utils import normalizer as jnorm
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision import (
    crop_randomizer as tcrop,
    multi_image_obs_encoder as tmio,
)
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.utils import normalizer as tnorm
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_diffusion_policy import (  # noqa: F401
    _jax_stage_dtypes,
    _normalizers,
    _random_like,
    _shapes,
    fixed_rng,
)
from test_torch_img_encoders import (  # noqa: F401
    IMG,
    backbones,
    f64_statistics,
    init_variables,
    one_torch_thread,
    tiny_vit_arch,
)

RESIZE, CROP = (40, 40), (32, 32)
RESIZE_F64 = (48, 48)  # its weights are exact in f32 (module doc)
# the ResNet cases whose train-mode gradients are held in f64: one shared
# model, one copy a camera, and one model shared by two cameras, whose
# batch statistics run over both cameras' stacked images (the depth-only
# and pointmap cases differ from "resnet-rgbd" in the stem's input width
# alone)
F64_CASES = ("resnet-rgbd", "resnet-rgbd-per_key-two_cameras", "resnet-rgb-two_cameras")
UNET = dict(horizon=8, n_action_steps=4, n_obs_steps=2, num_inference_steps=5,
            diffusion_step_embed_dim=16, down_dims=(16, 32), kernel_size=5, n_groups=8)
SCHED = dict(num_train_timesteps=5, beta_start=0.0001, beta_end=0.02,
             beta_schedule="squaredcos_cap_v2", clip_sample=True, prediction_type="epsilon")
TWO = ("base_camera", "hand_camera")
# name -> (backbone, channels, share_rgb_model, cameras)
ENCODER_CASES = {
    "resnet-rgbd": ("resnet", 4, True, ("base_camera",)),
    "resnet-depth_only": ("resnet", 1, True, ("base_camera",)),
    "resnet-pointmap": ("resnet", 6, True, ("base_camera",)),
    "resnet-rgb-two_cameras": ("resnet", 3, True, TWO),
    "resnet-rgbd-per_key-two_cameras": ("resnet", 4, False, TWO),
    "vit-rgb": ("vit", 3, True, ("base_camera",)),
    "vit-rgb-per_key-two_cameras": ("vit", 3, False, TWO),
    "multivit-rgbd": ("multivit", 4, True, ("base_camera",)),
}


def _close(got, ref, limit, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=limit, rtol=0,
                               err_msg=what)


def _scale(ref) -> float:
    return max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _encoder_kw(kind, channels, share, cameras):
    return dict(shape_meta=tentry.image_dp_shape_meta(channels, cameras), resize_shape=RESIZE,
                crop_shape=CROP, random_crop=False, share_rgb_model=share,
                use_depth=channels in (1, 4), only_depth=channels == 1)


def _encoders(kind, channels, share, cameras, **kw):
    """(JAX encoder, the port's) over a tiny backbone."""
    jnet, tnet = backbones(kind, channels, **({"avg_pool": True} if kind == "resnet" else {}))
    args = {**_encoder_kw(kind, channels, share, cameras), **kw}
    return (jmio.MultiImageObsEncoder(rgb_model=jnet, **args),
            tmio.MultiImageObsEncoder(rgb_model=tnet, **args))


def _obs(channels, cameras, rows, seed):
    """One frame of each key for ``rows`` rows, as ``_global_cond`` hands
    the encoder: (rows, IMG, IMG, c) images and (rows, 9) qpos."""
    batch = tentry.build_image_dp_batch(rows, IMG, channels, cameras, n_obs_steps=1,
                                        horizon=1, seed=seed)
    return {k: v[:, 0] for k, v in batch["obs"].items()}


def _rows(kind):
    return 8 if kind == "resnet" else 4  # ResNet's last stage is 1 x 1 at 32 px


def _f64_orders(case, variables, obs, cot) -> tuple:
    """ResNet's train-mode gradients in f64 with both packages' batch
    norms summing in f64: JAX's for the rows in their order and reversed,
    and the port's, as {parameter: array}. The encoders resize to
    ``RESIZE_F64``: under x64 JAX builds the resize's weights in f64, the
    port in f32 (``utils/image.py``), which at 24 -> 40 differ by 1.6e-6."""
    jm, tm = _encoders(*case, resize_shape=RESIZE_F64)
    with pytest.MonkeyPatch.context() as mp:
        f64_statistics(mp.setattr)
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
            stats = v64["batch_stats"]

            @jax.jit
            def grads(params, o, c):
                def loss(p):
                    out, _ = jm.apply({"params": p, "batch_stats": stats}, o, train=True,
                                      mutable=["batch_stats"])
                    return jnp.sum(out * c)
                return jax.grad(loss)(params)

            o64 = {k: v.astype(np.float64) for k, v in obs.items()}
            c64 = cot.astype(np.float64)
            orders = [jax.tree.map(np.asarray, grads(v64["params"], o, c))
                      for o, c in ((o64, c64), ({k: v[::-1] for k, v in o64.items()},
                                                c64[::-1]))]
        tm.load_state_dict(flax_to_torch(v64, tm), strict=True)
        tm.double()
        (tm(_t(o64), train=True) * torch.from_numpy(c64)).sum().backward()
    names = {n for n, _ in tm.named_parameters()}
    ref = [{n: v.numpy() for n, v in flax_to_torch({"params": g, "batch_stats": stats},
                                                    tm).items() if n in names} for g in orders]
    return ref, {n: p.grad.numpy() for n, p in tm.named_parameters()}


@pytest.fixture(scope="module", params=list(ENCODER_CASES))
def encoder_case(request, tiny_vit_arch):  # noqa: F811
    """JAX's randomised variables of a case and, in one compile: the eval
    features, the train-mode features and the batch statistics after them
    and (but for ResNet) the gradients of sum(features * cot); for ResNet
    the f64 gradients of :func:`_f64_orders`."""
    kind, channels, share, cameras = ENCODER_CASES[request.param]
    jm, _ = _encoders(kind, channels, share, cameras)
    obs = _obs(channels, cameras, _rows(kind), 0)
    variables = init_variables(jm, jax.tree.map(jnp.asarray, obs))
    stats = variables.get("batch_stats", {})
    width = jax.eval_shape(lambda v, o: jm.apply(v, o), variables, obs).shape[-1]
    cot = np.random.RandomState(1).randn(len(obs["qpos"]), width).astype(np.float32)

    def ref(params, o, cot):
        def loss(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, o, train=True,
                                mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut.get("batch_stats", {}))

        evaluated = jm.apply({"params": params, "batch_stats": stats}, o)
        if kind == "resnet":
            return evaluated, *loss(params)[1], None
        (_, (out, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return evaluated, out, new_stats, grads

    out = jax.tree.map(np.asarray, jax.jit(ref)(variables["params"], obs, cot))
    f64 = _f64_orders(ENCODER_CASES[request.param], variables, obs, cot) \
        if request.param in F64_CASES else None
    return dict(name=request.param, case=(kind, channels, share, cameras), variables=variables,
                obs=obs, cot=cot, width=width, eval=out[0], train=out[1:], f64=f64)


def _port_encoder(case):
    _, tm = _encoders(*case["case"])
    tm.load_state_dict(flax_to_torch(case["variables"], tm), strict=True)
    return tm


def _grad_excess(got: dict, ref: dict, rel: float) -> tuple:
    """(largest |got - ref| / (rel * max(1, max|ref|)) over the tensors,
    its name): at most 1 where every gradient is within its limit."""
    return max((np.abs(got[n] - ref[n]).max() / (rel * max(1.0, np.abs(ref[n]).max())), n)
               for n in ref)


def test_encoder_width_and_eval_match_jax(encoder_case):
    """``feature_dim`` is the width JAX's ``init`` infers; the per-key
    copies are the port's only backbones without a shared model; the eval
    features within 1e-5 · max(1, max|JAX|)."""
    tm = _port_encoder(encoder_case)
    kind, channels, share, cameras = encoder_case["case"]
    assert tm.feature_dim == encoder_case["width"]
    assert tm.feature_dim == len(cameras) * tmio.pooled_width(
        tm.rgb_model if share else tm.key_models()[f"{cameras[0]}_rgb"]) + 9
    assert hasattr(tm, "rgb_model") == share
    assert sorted(tm.key_models()) == ([] if share else sorted(f"{c}_rgb" for c in cameras))
    got = tm(_t(encoder_case["obs"]), train=False)
    ref = encoder_case["eval"]
    assert tuple(got.shape) == ref.shape
    _close(got, ref, 1e-5 * _scale(ref), "eval features")


def test_encoder_train_matches_jax(encoder_case):
    """Training: the features within 1e-4 · max(1, max|JAX|), the running
    statistics after them within 1e-5, every gradient within 1e-4 ·
    max(1, max|g|) of its tensor. ResNet's gradients in f64 with f64
    statistics on both sides, where JAX's two row orders agree, within
    1e-8 · max(1, max|g|) of each: in f32 a ReLU input within a
    statistic's rounding of zero routes by the order of its sum (ROADMAP.md
    §3, "Batch order under batch norms"), and the port's order moved a
    gradient of ``resnet-rgb-two_cameras`` by 15% of its largest entry on a
    batch where JAX's two orders agree with each other; in f64 that case
    agrees with both of JAX's orders."""
    tm = _port_encoder(encoder_case)
    kind = encoder_case["case"][0]
    out, stats, grads = encoder_case["train"]
    got = tm(_t(encoder_case["obs"]), train=True)
    _close(got, out, 1e-4 * _scale(out), "train features")
    variables = encoder_case["variables"]
    after = flax_to_torch({"params": variables["params"], "batch_stats": stats}, tm)
    names = {n for n, _ in tm.named_parameters()}
    for name, buf in tm.state_dict().items():
        if name not in names:
            _close(buf, after[name], 1e-5 * _scale(after[name]), name)
    if kind == "resnet" and encoder_case["f64"] is None:
        return
    if encoder_case["f64"] is None:
        (got * torch.from_numpy(encoder_case["cot"])).sum().backward()
        ref = flax_to_torch({"params": grads, "batch_stats": stats}, tm)
        for name, p in tm.named_parameters():
            g = ref[name].numpy()
            _close(p.grad, g, 1e-4 * _scale(g), f"grad {name}")
        return
    (given, reversed_), port = encoder_case["f64"]
    assert _grad_excess(reversed_, given, 1e-8)[0] <= 1
    for ref in (given, reversed_):
        gap = _grad_excess(port, ref, 1e-8)
        assert gap[0] <= 1, gap


# ---------------------------------------------------------------------------
# crops
# ---------------------------------------------------------------------------

IMAGES = np.random.RandomState(4).rand(3, 12, 10, 2).astype(np.float32)


def test_center_crop_is_jax_bit_for_bit():
    for h, w in ((12, 10), (7, 4), (1, 1), (8, 9)):
        ref = np.asarray(jmio.center_crop(jnp.asarray(IMAGES), h, w))
        assert np.array_equal(tmio.center_crop(torch.from_numpy(IMAGES), h, w).numpy(), ref)


def test_crop_image_from_indices_is_jax_bit_for_bit():
    idx = np.random.RandomState(5).randint(0, 5, (3, 4, 2)).astype(np.int32)
    ref = np.asarray(jcrop.crop_image_from_indices(jnp.asarray(IMAGES), jnp.asarray(idx), 7, 5))
    got = tcrop.crop_image_from_indices(torch.from_numpy(IMAGES), torch.from_numpy(idx), 7, 5)
    assert got.shape == (3, 4, 7, 5, 2) and np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("num_crops, pos_enc", [(1, False), (1, True), (3, True), (2, False)])
def test_crop_randomizer_is_jax_bit_for_bit(num_crops, pos_enc, monkeypatch):
    """``forward_in`` at eval and in training (JAX's offsets drawn from one
    key on both sides), ``forward_out``, the output shapes."""
    jm = jcrop.CropRandomizer(input_shape=(12, 10, 2), crop_height=7, crop_width=5,
                              num_crops=num_crops, pos_enc=pos_enc)
    tm = tcrop.CropRandomizer(input_shape=(12, 10, 2), crop_height=7, crop_width=5,
                              num_crops=num_crops, pos_enc=pos_enc)
    assert tm.output_shape_in() == jm.output_shape_in() and tm.output_shape_out([4]) == [4]
    x = jnp.asarray(IMAGES)
    ref = np.asarray(jm.apply({}, x, train=False))
    got = tm(torch.from_numpy(IMAGES), train=False)
    assert np.array_equal(got.numpy(), ref) and got.shape[-1] == tm.output_shape_in()[-1]
    key = jax.random.PRNGKey(3)  # JAX's "dropout" key, its offsets on both sides
    monkeypatch.setattr(jcrop.CropRandomizer, "make_rng", lambda self, name: key)
    kh, kw = jax.random.split(key)
    monkeypatch.setattr(tcrop, "crop_indices", lambda gen, shape, H, W, ch, cw: torch.stack(
        [torch.from_numpy(np.asarray(jax.random.randint(kh, shape, 0, H - ch))),
         torch.from_numpy(np.asarray(jax.random.randint(kw, shape, 0, W - cw)))], dim=-1))
    ref = np.asarray(jm.apply({}, x, train=True))
    got = tm(torch.from_numpy(IMAGES), train=True, rngs={"dropout": torch.Generator()})
    assert got.shape == ref.shape and np.array_equal(got.numpy(), ref)
    feats = np.random.RandomState(6).rand(3 * num_crops, 5).astype(np.float32)
    assert np.array_equal(tm.forward_out(torch.from_numpy(feats)).numpy(),
                          np.asarray(jm.apply({}, jnp.asarray(feats), method=jm.forward_out)))


def test_draws_ranges_and_streams():
    """The encoder's offsets cover [0, H - h] and ``CropRandomizer``'s
    [0, H - h) (both as JAX draws them), each from its stream; a training
    crop without its stream raises."""
    gen = torch.Generator().manual_seed(0)
    tops, lefts = tmio.crop_offsets(gen, 4000, 12, 10, 7, 5)
    assert (tops.min(), tops.max(), lefts.min(), lefts.max()) == (0, 5, 0, 5)
    idx = tcrop.crop_indices(gen, (4000,), 12, 10, 7, 5)
    assert (idx[:, 0].min(), idx[:, 0].max(), idx[:, 1].min(), idx[:, 1].max()) == (0, 4, 0, 4)
    assert tcrop.crop_indices(gen, (50,), 7, 5, 7, 5).abs().max() == 0
    for H, h in ((12, 7), (12, 12)):
        j = jax.random.randint(jax.random.PRNGKey(1), (4000,), 0, H - h + 1)
        assert int(j.max()) == H - h
    _, tm = _encoders("resnet", 3, True, ("base_camera",), random_crop=True)
    obs = _t(_obs(3, ("base_camera",), 2, 0))
    with pytest.raises(ValueError, match="crop"):
        tm(obs, train=True, rngs={"dropout": torch.Generator()})
    one = tm(obs, train=True, rngs={"crop": torch.Generator().manual_seed(1)})
    assert torch.equal(one, tm(obs, train=True, rngs={"crop": torch.Generator().manual_seed(1)}))
    with pytest.raises(ValueError, match="dropout"):
        tcrop.CropRandomizer((12, 10, 2), 7, 5)(torch.from_numpy(IMAGES), train=True,
                                                rngs={"crop": gen})


def test_random_crops_match_jax_with_its_offsets(monkeypatch, tiny_vit_arch):  # noqa: F811
    """The encoder in training with ``random_crop`` (the ViT: no batch
    statistics): JAX's ``make_rng("crop")`` hands out fixed keys, one a
    transform, and the port's draw returns JAX's offsets from them; the
    features within 1e-5 · max(1, max|JAX|)."""
    cameras = TWO
    jm, tm = _encoders("vit", 3, True, cameras, random_crop=True)
    obs = _obs(3, cameras, 4, 2)
    variables = init_variables(jm, jax.tree.map(jnp.asarray, obs))
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    keys = [jax.random.PRNGKey(9 + i) for i in range(len(cameras))]  # a key a transform
    drawn = iter(keys)
    monkeypatch.setattr(jmio.MultiImageObsEncoder, "make_rng", lambda self, name: next(drawn))
    ref = jm.apply(variables, obs, train=True)
    port_keys = iter(keys)

    def crop_offsets(gen, batch, H, W, h, w):
        kh, kw = jax.random.split(next(port_keys))
        return (torch.from_numpy(np.asarray(jax.random.randint(kh, (batch,), 0, H - h + 1))),
                torch.from_numpy(np.asarray(jax.random.randint(kw, (batch,), 0, W - w + 1))))

    monkeypatch.setattr(tmio, "crop_offsets", crop_offsets)
    got = tm(_t(obs), train=True, rngs={"crop": torch.Generator()})
    _close(got, ref, 1e-5 * _scale(ref), "random crops")
    ref_centre = jm.apply(variables, obs, train=False)
    assert not np.allclose(np.asarray(ref), np.asarray(ref_centre))


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

POLICY_CASES = {"resnet-rgbd": ("resnet", 4, True, ("base_camera",)),
                "vit-rgb-per_key-two_cameras": ("vit", 3, False, TWO)}


def _image_normalizers(cameras, channels):
    """A fitted normalizer of each package with identity entries for the
    image keys, as the DP RGB-D datasets build theirs."""
    jn, tn = _normalizers()
    for key in tentry.image_dp_shape_meta(channels, cameras)["obs"]:
        if key != "qpos":
            jn[key] = jnorm.SingleFieldLinearNormalizer.create_identity()
            tn[key] = tnorm.SingleFieldLinearNormalizer.create_identity()
    return jn, tn


def _policy_batch(kind, channels, cameras, with_action=True, seed=0):
    return tentry.build_image_dp_batch(4 if kind == "resnet" else 2, IMG, channels, cameras,
                                       horizon=UNET["horizon"], seed=seed,
                                       with_actions=with_action)


def _policies(name, normalized=True):
    """The JAX and the port's tiny policy with the same normalizer and the
    same random variables."""
    kind, channels, share, cameras = POLICY_CASES[name]
    jn, tn = _image_normalizers(cameras, channels) if normalized else (None, None)
    jenc, _ = _encoders(kind, channels, share, cameras)
    meta = tentry.image_dp_shape_meta(channels, cameras)
    jpolicy = jdp.DiffusionUnetImagePolicy(
        shape_meta=meta, noise_scheduler=jddpm.DDPMScheduler(**SCHED), obs_encoder=jenc,
        normalizer=jn, **UNET)
    variables = _random_like(_shapes(jpolicy, _policy_batch(kind, channels, cameras),
                                     train=True), 7)
    backbone_kw = {"resnet": dict(resnet_model="resnet18", resize_to=32),
                   "vit": dict(model_name="vit_tiny_test", img_size=32),
                   "multivit": dict(img_size=32, dim_tokens=32, depth=2, num_heads=4)}[kind]
    tpolicy = tentry.build_image_dp_policy(
        kind, channels, share_rgb_model=share, cameras=cameras, normalizer=tn,
        backbone_kw=backbone_kw, encoder_kw=dict(resize_shape=RESIZE, crop_shape=CROP),
        num_train_timesteps=5, device="cpu", **UNET)
    tpolicy.load_state_dict(flax_to_torch(variables, tpolicy), strict=True)
    return jpolicy, tpolicy, variables


@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_policy_loss_and_gradients_match_jax(name, fixed_rng, tiny_vit_arch):  # noqa: F811
    """The train-mode loss within 1e-4 relative and the gradients within
    1e-4 of each tensor's largest entry (below 1e-6 of the model's largest
    on both sides where JAX's is), JAX's noise and timesteps on both sides;
    over ResNet the gradients of the loss with its batch norms at their
    running statistics."""
    jpolicy, tpolicy, variables = _policies(name)
    variables = {"batch_stats": {}, **variables}
    kind = POLICY_CASES[name][0]
    batch = _policy_batch(kind, *POLICY_CASES[name][1:4:2])
    grad_train = kind != "resnet"

    def loss_fn(params, b, train):
        out, mut = jpolicy.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                                 train=train, mutable=["batch_stats"])
        return out["loss"], mut

    jb = jax.tree.map(jnp.asarray, batch)
    g_loss, grads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, grad_train)[0]))(
        variables["params"], jb)
    loss = g_loss if grad_train else jax.jit(lambda p, b: loss_fn(p, b, True)[0])(
        variables["params"], jb)
    out = tpolicy(_t(batch), train=True, rngs={"noise": torch.Generator()})
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss), rtol=1e-4)
    if not grad_train:  # from JAX's running statistics: the step above moved the port's
        tpolicy.load_state_dict(flax_to_torch(variables, tpolicy), strict=True)
        tpolicy.zero_grad()
        out = tpolicy(_t(batch), train=False, rngs={"noise": torch.Generator()})
        np.testing.assert_allclose(float(out["loss"].detach()), float(g_loss), rtol=1e-4)
    out["loss"].backward()
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, grads),
                         "batch_stats": variables["batch_stats"]}, tpolicy)
    largest = max(np.abs(r.numpy()).max() for r in ref.values())
    checked = 0
    for pname, p in tpolicy.named_parameters():
        r = ref[pname].numpy()
        if np.abs(r).max() <= 1e-6 * largest:
            assert p.grad is None or p.grad.abs().max() <= 1e-6 * largest, pname
        else:
            _close(p.grad, r, 1e-4 * np.abs(r).max(), f"d {pname}")
            checked += 1
    assert checked > len(ref) // 2


def test_sampling_chain_matches_jax(fixed_rng):
    """The 5-step reverse chain in eval mode from JAX's own draws:
    ``action_pred`` and the executed window within 1e-4 · max(1, max|JAX|),
    inside the normalizer's range."""
    jpolicy, tpolicy, variables = _policies("resnet-rgbd")
    batch = _policy_batch("resnet", 4, ("base_camera",), with_action=False)
    ref = jax.jit(lambda v, b: jpolicy.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    got = tpolicy(_t(batch), train=False, rngs={"sample": torch.Generator()})
    assert got["action_pred"].shape == (4, 8, 7) and got["action"].shape == (4, 4, 7)
    for key in ("action_pred", "action", "a_hat"):
        _close(got[key], ref[key], 1e-4 * _scale(ref[key]), key)
    a = got["action"].detach().numpy()
    assert a.min() >= 5.0 - 1e-3 and a.max() <= 9.0 + 1e-3


@pytest.mark.parametrize("normalized", [True, False], ids=["normalizer", "no_normalizer"])
def test_bf16_step_stage_dtypes_equal_jax(normalized):
    """In the ``"bf16-mixed"`` step every module both packages have takes
    and gives JAX's element types: with the dataset's normalizer the images
    are f32 and the backbone f32 on bf16 weights (flax promotes), the
    condition, the UNet and the loss f32; without one all of it is bf16."""
    jpolicy, tpolicy, variables = _policies("resnet-rgbd", normalized)
    batch = _policy_batch("resnet", 4, ("base_camera",))
    ref = _jax_stage_dtypes(jpolicy, variables, batch)
    seen, names = {}, {m: n for n, m in tpolicy.named_modules()}

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
    assert len(common) > 80 and {"model", "obs_encoder", "obs_encoder.rgb_model",
                                 "obs_encoder.rgb_model.conv1", "obs_encoder.rgb_model.bn1",
                                 "model.down0_res0.block0.norm", "loss"} <= set(common)
    differ = {k: (ref[k], seen[k]) for k in common
              if name(ref[k][1]) != name(seen[k][1])
              or not (ref[k][0] is None or seen[k][0] is None)
              and name(ref[k][0]) != name(seen[k][0])}
    assert not differ, differ
    backbone = "float32" if normalized else "bfloat16"
    assert name(seen["obs_encoder.rgb_model"][0]) == backbone
    assert name(seen["obs_encoder.rgb_model.layer4_1.conv2"][1]) == backbone
    assert name(seen["model"][0]) == name(seen["loss"][1]) == (
        "float32" if normalized else "bfloat16")


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_key"])
def test_pretrained_weights_reach_the_shared_model_only(share, tmp_path, caplog):
    """A ResNet-18 with a ``pretrained_path`` (an R3M-style file of a seeded
    ResNet-18's weights): the shared ``rgb_model`` loads it in both
    packages, equal after ``flax_to_torch``; the per-key copies load
    nothing in JAX (they are not module fields) nor in the port, whose
    encoder clears their paths and says so once."""
    from pointcloudmatters_tpu.models.components import pretrained as jpretrained
    from pointcloudmatters_tpu_torch.models.components import pretrained as tpretrained
    from tools.reference_ckpt import backbone_state_dict

    source = backbones("resnet", 3, avg_pool=True)[1]
    tentry.init_parameters(source, torch.Generator().manual_seed(8))
    path = tmp_path / "r3m_50.pt"
    torch.save({"r3m": {f"module.convnet.{k}": v for k, v in
                        backbone_state_dict(source).items()}}, path)
    cameras = TWO
    jnet, tnet = backbones("resnet", 3, avg_pool=True)
    for net in (jnet, tnet):  # the configs set the path on the rgb_model they hand over
        object.__setattr__(net, "pretrained_path", str(path))
    args = _encoder_kw("resnet", 3, share, cameras)
    jm = jmio.MultiImageObsEncoder(rgb_model=jnet, **args)
    with caplog.at_level("WARNING"):
        tm = tmio.MultiImageObsEncoder(rgb_model=tnet, **args)
    variables = init_variables(jm, jax.tree.map(jnp.asarray, _obs(3, cameras, 2, 0)))
    loaded = jpretrained.load_pretrained_into(jm, variables)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with caplog.at_level("WARNING"):
        tpretrained.load_pretrained_into(tm)
    after = tm.state_dict()
    want = flax_to_torch(loaded, tm)
    assert all(torch.equal(after[k], want[k]) for k in after)
    if share:
        assert all(torch.equal(after[f"rgb_model.{k}"], v)
                   for k, v in source.state_dict().items())
    else:
        assert all(torch.equal(after[k], before[k]) for k in after)
        warned = [r for r in caplog.records if "per-key image models" in r.getMessage()]
        assert len(warned) == 1 and "model_base_camera_rgb" in warned[0].getMessage()
