"""The image Diffusion Policy's encoder over per-key image models that do not
pool, the port against the JAX package, on the CPU.

JAX flattens each key's features to (B, -1) (``multi_image_obs_encoder.py``
``reshape(batch_size, -1)``) and sizes the UNet from that width at
``init``; a shared model that does not pool raises ``ValueError`` when
called. The port sizes the UNet at construction, so its encoder takes the
width from a forward of the key's model on the meta device
(``unpooled_width``), and raises the ``ValueError`` at construction.

- Per key, two cameras of 64 x 64 RGB-D (``use_depth``) centre-cropped to
  56: ResNet-18 without ``avg_pool`` (resizing to 64: (B, 2, 2, 512) a key)
  and the tiny ViT with ``reshape_embedding`` ((B, 4, 4, 32) a key) on
  JAX's randomised variables (``flax_to_torch``): ``feature_dim`` equal to
  the width JAX's ``init`` infers, the eval features within 1e-5 ·
  max(1, max|JAX|) and (B, feature_dim), the flattening JAX does; the
  construction leaves the template's tensors (batch-norm running
  statistics too) and torch's global random state as they were.
- The same with the hand camera at 48 x 48 and no crop: each key's width
  is taken at that key's own input shape (the ResNet resizes both to 64).
- A shared model that does not pool raises ``ValueError`` in both packages.
- Where a layer cannot run on the meta device, the width comes from a
  batch-1 CPU forward that touches no tensor of the model.
- The policy over the per-key ViT: the UNet's condition widths follow,
  ``flax_to_torch`` carries JAX's variables across with ``strict=True``,
  and the 5-step chain with JAX's draws agrees within 1e-4 · max(1,
  max|JAX|); the reference converter (``port_reference_ckpt``) gives, bit
  for bit, what the JAX script then ``flax_to_torch`` gives, as
  ``tests/test_torch_ckpt_port.py`` holds the other families; and
  ``tools/jax_form.py``'s ``torch_to_flax`` gives JAX's variables back, leaf for leaf.
"""

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
    multi_image_obs_encoder as jmio,
)
from pointcloudmatters_tpu.models.components.img_encoder import resnet as jresnet
from pointcloudmatters_tpu.models.components.img_encoder import vit as jvit
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch import port_reference_ckpt as tport
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision import (
    multi_image_obs_encoder as tmio,
)
from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet as tresnet
from pointcloudmatters_tpu_torch.models.components.img_encoder import vit as tvit
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_ckpt_port import JPORT, _reference, _seeded, traced_init  # noqa: F401
from test_torch_diffusion_policy import _random_like, _shapes, fixed_rng  # noqa: F401
from test_torch_img_encoders import (  # noqa: F401
    TINY_VIT,
    init_variables,
    one_torch_thread,
    tiny_vit_arch,
)
from tools.jax_form import torch_to_flax

SIDE, CROP = 64, (56, 56)
TWO = ("base_camera", "hand_camera")
UNET = dict(horizon=8, n_action_steps=4, n_obs_steps=2, num_inference_steps=5,
            diffusion_step_embed_dim=16, down_dims=(16, 32), kernel_size=5, n_groups=8)
SCHED = dict(num_train_timesteps=5, beta_start=0.0001, beta_end=0.02,
             beta_schedule="squaredcos_cap_v2", clip_sample=True, prediction_type="epsilon")
# kind -> (the backbone's keywords, JAX's and the port's class, the width a key)
UNPOOLED = {
    "resnet": (dict(resnet_model="resnet18", resize_to=64, avg_pool=False),
               jresnet.ResNetTorchVision, tresnet.ResNetTorchVision, 2 * 2 * 512),
    "vit": (dict(model_name=TINY_VIT, img_size=32, feature_mode="reshape_embedding"),
            jvit.ViT, tvit.ViT, 4 * 4 * 32),
}


def _backbones(kind):
    kw, jcls, tcls, _ = UNPOOLED[kind]
    return jcls(channels=4, **kw), tcls(channels=4, **kw)


HAND_SIDE = 48  # the hand camera's side in the case of two camera sizes, uncropped


def _encoder_kw(share, two_sizes=False):
    meta = tentry.image_dp_shape_meta(4, TWO, side=SIDE)
    if two_sizes:
        for key in ("hand_camera_rgb", "hand_camera_depth"):
            meta["obs"][key]["shape"][:2] = [HAND_SIDE, HAND_SIDE]
    return dict(shape_meta=meta, crop_shape=None if two_sizes else CROP, random_crop=False,
                share_rgb_model=share, use_depth=True)


def _obs(rows=2, seed=0, two_sizes=False):
    batch = tentry.build_image_dp_batch(rows, SIDE, 4, TWO, n_obs_steps=1, horizon=1,
                                        seed=seed)
    obs = {k: v[:, 0] for k, v in batch["obs"].items()}
    if two_sizes:
        for key in ("hand_camera_rgb", "hand_camera_depth"):
            obs[key] = np.ascontiguousarray(obs[key][:, :HAND_SIDE, :HAND_SIDE])
    return obs


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("kind, two_sizes", [("resnet", False), ("vit", False),
                                             ("resnet", True)],
                         ids=["resnet", "vit", "resnet-two_sizes"])
def test_per_key_unpooled_features_match_jax(kind, two_sizes, tiny_vit_arch):  # noqa: F811
    jnet, tnet = _backbones(kind)
    jm = jmio.MultiImageObsEncoder(rgb_model=jnet, **_encoder_kw(False, two_sizes))
    obs = _obs(two_sizes=two_sizes)
    variables = init_variables(jm, jax.tree.map(jnp.asarray, obs))
    ref = np.asarray(jax.jit(lambda v, o: jm.apply(v, o))(variables, obs))
    width = UNPOOLED[kind][3]
    assert ref.shape == (2, 2 * width + 9)

    before, rng = _state(tnet), torch.get_rng_state()
    tm = tmio.MultiImageObsEncoder(rgb_model=tnet, **_encoder_kw(False, two_sizes))
    after = _state(tnet)
    assert torch.equal(torch.get_rng_state(), rng)
    assert before.keys() == after.keys() and all(torch.equal(before[k], after[k])
                                                 for k in before)
    assert tm.key_widths == dict.fromkeys(tm.rgb_keys, width)
    assert tm.feature_dim == ref.shape[-1]
    assert not tmio.pools(tnet)

    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    got = tm({k: torch.from_numpy(v) for k, v in obs.items()}, train=False)
    assert tuple(got.shape) == ref.shape  # each key's map flattened, as JAX's reshape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("kind", list(UNPOOLED))
def test_a_shared_unpooled_model_raises_in_both(kind, tiny_vit_arch):  # noqa: F811
    jnet, tnet = _backbones(kind)
    jm = jmio.MultiImageObsEncoder(rgb_model=jnet, **_encoder_kw(True))
    obs = jax.tree.map(jnp.asarray, _obs())
    with pytest.raises(ValueError, match="must pool"):
        jax.eval_shape(lambda o: jm.init(jax.random.PRNGKey(0), o), obs)
    with pytest.raises(ValueError, match="must pool"):
        tmio.MultiImageObsEncoder(rgb_model=tnet, **_encoder_kw(True))
    with pytest.raises(ValueError, match="must pool"):
        tmio.pooled_width(tnet)


class _NoMeta(tresnet.ResNetTorchVision):
    """ResNet-18 that reads a value of its input, which a meta tensor has not."""

    def forward(self, x, train=False):
        if not torch.isfinite(x.sum()).item():
            raise AssertionError("the sizing image is zeros")
        return super().forward(x, train=train)


def test_the_width_falls_back_to_a_cpu_forward_that_touches_nothing():
    kw = UNPOOLED["resnet"][0]
    tnet = _NoMeta(channels=4, **kw)
    with pytest.raises((NotImplementedError, RuntimeError)):
        tnet(torch.empty((1, SIDE, SIDE, 4), device="meta"))
    with torch.no_grad():
        for name, buf in tnet.named_buffers():
            if name.endswith((".mean", ".var")):
                buf.uniform_(0.5, 1.5)
    before, rng = _state(tnet), torch.get_rng_state()
    tm = tmio.MultiImageObsEncoder(rgb_model=tnet, **_encoder_kw(False))
    assert torch.equal(torch.get_rng_state(), rng)
    assert all(torch.equal(before[k], v) for k, v in _state(tnet).items())
    assert tm.key_widths == dict.fromkeys(tm.rgb_keys, UNPOOLED["resnet"][3])
    assert tmio.unpooled_width(tresnet.ResNetTorchVision(channels=4, **kw), (*CROP, 4)) \
        == UNPOOLED["resnet"][3]


def _policies():
    """The JAX and the port's policy over a per-key unpooled tiny ViT, the
    same random variables."""
    meta = tentry.image_dp_shape_meta(4, TWO, side=SIDE)
    jnet, _ = _backbones("vit")
    jenc = jmio.MultiImageObsEncoder(rgb_model=jnet, **_encoder_kw(False))
    jpolicy = jdp.DiffusionUnetImagePolicy(shape_meta=meta,
                                           noise_scheduler=jddpm.DDPMScheduler(**SCHED),
                                           obs_encoder=jenc, **UNET)
    batch = tentry.build_image_dp_batch(2, SIDE, 4, TWO, horizon=UNET["horizon"], seed=0)
    variables = _random_like(_shapes(jpolicy, batch, train=True), 7)
    tpolicy = tentry.build_image_dp_policy(
        "vit", 4, share_rgb_model=False, cameras=TWO, backbone_kw=dict(UNPOOLED["vit"][0]),
        encoder_kw=dict(resize_shape=None, crop_shape=CROP), num_train_timesteps=5,
        device="cpu", **UNET)
    return jpolicy, tpolicy, variables


def test_the_policy_sizes_its_unet_and_samples_as_jax(fixed_rng, tiny_vit_arch):  # noqa: F811
    jpolicy, tpolicy, variables = _policies()
    width = 2 * UNPOOLED["vit"][3] + 9
    assert tpolicy.global_cond_dim == width * UNET["n_obs_steps"] + 3
    tpolicy.load_state_dict(flax_to_torch(variables, tpolicy), strict=True)
    back = torch_to_flax(tpolicy)  # JAX's tree again: ViT's heads, the UNet's convolutions
    assert back["batch_stats"] == {} and "batch_stats" not in variables
    assert jax.tree.structure(back["params"]) == jax.tree.structure(variables["params"])
    assert all(a.shape == np.shape(b) and np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back["params"]), jax.tree.leaves(variables["params"])))
    batch = tentry.build_image_dp_batch(2, SIDE, 4, TWO, horizon=UNET["horizon"], seed=1,
                                        with_actions=False)
    ref = jax.jit(lambda v, b: jpolicy.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    got = tpolicy({"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
                   "goal": {k: torch.from_numpy(v) for k, v in batch["goal"].items()}},
                  train=False, rngs={"sample": torch.Generator()})
    for key in ("action_pred", "action"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].detach().numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(r).max())), err_msg=key)


def test_the_reference_converter_carries_the_wider_condition(traced_init,  # noqa: F811
                                                             tiny_vit_arch):  # noqa: F811
    policy = _seeded(tentry.build_image_dp_policy(
        "resnet", 3, share_rgb_model=False, cameras=TWO,
        backbone_kw=dict(UNPOOLED["resnet"][0]), encoder_kw=dict(resize_shape=None,
                                                                 crop_shape=CROP),
        num_train_timesteps=5, device="cpu", **UNET))
    assert policy.global_cond_dim == (2 * UNPOOLED["resnet"][3] + 9) * 2 + 3
    own = {k: v.clone() for k, v in policy.state_dict().items()}
    sd = _reference(policy, {})
    got = tport.port_state_dict(sd)
    ref = JPORT.port_state_dict({k: v.numpy() for k, v in sd.items()}, nhead=4)
    want = flax_to_torch({"params": ref["params"], "batch_stats": ref["batch_stats"]}, policy)
    merged = {**got["params"], **got["batch_stats"]}
    assert set(merged) == set(want) == set(own)
    differ = [k for k in merged if not torch.equal(merged[k], want[k])
              or not torch.equal(merged[k], own[k])]
    assert not differ, differ[:5]
    policy.load_state_dict(merged, strict=True)
