"""The port's reference-checkpoint converter
(``pointcloudmatters_tpu_torch/port_reference_ckpt.py``) against the JAX
package's (``scripts/port_reference_ckpt.py``, loaded by its path as
``tests/test_ckpt_port.py`` loads it), on the CPU.

There is no reference-trained checkpoint here (``tests/test_ckpt_port.py``
skips without the reference tree), so each family's reference state dict
is made from a seeded port model by ``tools/reference_ckpt.py``: its
tensors under the reference's key names and layouts (spconv planes,
``nn.MultiheadAttention``'s ``in_proj``, torchvision's, timm's and
MultiMAE's names, the DP's ``Sequential`` indices and ``key_model_map``,
``num_batches_tracked`` and a metric's state beside them).

- For every family the port's converter gives, bit for bit, what the JAX
  script's ``port_state_dict`` followed by ``flax_to_torch`` onto the port's
  model gives (each tensor, the split into parameters and batch
  statistics, the normalizer in the extras), and that is the seeded model's
  own state; the model loads it with ``strict=True``. The families: ACT /
  ACTPCD over PointNet, SpUNet, ResNet (a DETR ``Joiner`` and direct),
  ViT-B/16 (the JAX script takes base/16 and large/16 only, so this one is
  at full width), MultiViT (width 768, as the JAX script requires, one
  block) and no backbone (the state-only ACT); the DP over PointNet and over images (one shared ResNet, a
  ResNet a camera).
- The command line round trip: a saved ``.ckpt``, ``python -m
  pointcloudmatters_tpu_torch.port_reference_ckpt``, ``Trainer.restore_checkpoint``
  into a fresh DP module, then ``predict`` with JAX's draws within 1e-4 ·
  max(1, max|JAX|) of JAX's policy on the JAX script's trees.
- The refusals: an unknown ResNet depth, ViT or MultiViT width (as JAX's),
  an unknown ``--policy``. The state-only ACT's entries convert.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.components.diffusion_policy import (
    diffusion_unet_image_policy as jdp,
)
from pointcloudmatters_tpu.models.components.img_encoder import multivit as jmultivit
from pointcloudmatters_tpu.models.components.img_encoder import resnet as jresnet
from pointcloudmatters_tpu.models.components.img_encoder import vit as jvit
from pointcloudmatters_tpu.models.components.pcd_encoder import spunet as jspunet
from pointcloudmatters_tpu.utils import normalizer as jnorm
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch import port_reference_ckpt as tport
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.trainer import CHECKPOINT_FILE, Trainer, read_checkpoint
from pointcloudmatters_tpu_torch.utils import normalizer as tnorm
from pointcloudmatters_tpu_torch.utils.flax_to_torch import arrays_to_tensors, flax_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_diffusion_policy import fixed_rng  # noqa: F401
from test_torch_image_dp import CROP, RESIZE, _encoders, _image_normalizers
from test_torch_img_encoders import IMG, one_torch_thread, tiny_vit_arch  # noqa: F401
from tools.reference_ckpt import reference_state_dict, save_lightning_ckpt

REPO = pathlib.Path(__file__).resolve().parent.parent
ACT_TINY = dict(hidden_dim=32, chunk=5, enc_layers=1, dec_layers=2, nhead=4, device="cpu")
SPUNET = dict(base_channels=8, channels=[8, 16, 16, 16, 16, 16, 12, 12],
              layers=[1, 1, 1, 1, 1, 1, 1, 1])
RESNET18 = dict(resnet_model="resnet18", resize_to=32)
UNET = dict(down_dims=(16, 32), diffusion_step_embed_dim=16, horizon=8, n_action_steps=4,
            num_inference_steps=5, num_train_timesteps=5)
TWO = ("base_camera", "hand_camera")


def _jax_porter():
    spec = importlib.util.spec_from_file_location(
        "jax_port_reference_ckpt", REPO / "scripts" / "port_reference_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JPORT = _jax_porter()


def _normalizer(keys=()):
    """A fitted port normalizer (action, qpos) with identity image keys."""
    rng = np.random.RandomState(0)
    n = tnorm.LinearNormalizer()
    n.fit({"action": rng.uniform(5.0, 9.0, (100, 7)).astype(np.float32),
           "qpos": rng.randn(100, 9).astype(np.float32)})
    for k in keys:
        n[k] = tnorm.SingleFieldLinearNormalizer.create_identity()
    return n


def _seeded(policy, seed=5):
    """Random running statistics (positive variances) on a seeded policy."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in policy.named_buffers():
            if name.endswith((".mean", ".var")):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.25)
    return policy


FAMILIES = {
    "act-pointnet": lambda: (tentry.build_flagship(npoints=16, nsample=4, **ACT_TINY), {}),
    "act-spunet": lambda: (tentry.build_flagship(npoints=16, nsample=4, backbone="spunet",
                                                 spunet=SPUNET, **ACT_TINY), {}),
    "act-resnet-joiner": lambda: (tentry.build_image_policy(
        "resnet", 4, backbone_kw=RESNET18, **ACT_TINY), {}),
    "act-resnet-direct": lambda: (tentry.build_image_policy(
        "resnet", 3, backbone_kw=RESNET18, **ACT_TINY), {"resnet_prefix": ""}),
    "act-vit-b16": lambda: (tentry.build_image_policy("vit", 3, **ACT_TINY), {}),
    "act-multivit": lambda: (tentry.build_image_policy(
        "multivit", 4, backbone_kw=dict(depth=1), **ACT_TINY), {}),
    "act-state": lambda: (tentry.build_state_policy(env_state_dim=5, **ACT_TINY), {}),
    "dp-pointnet": lambda: (tentry.build_dp_policy(
        npoints=16, nsample=4, hidden_dim=32, projector_channels=(32, 48, 48), num_classes=32,
        device="cpu", **UNET), {"normalizer": _normalizer().state_dict()}),
    "dp-image-shared": lambda: (tentry.build_image_dp_policy(
        "resnet", 4, backbone_kw=RESNET18, device="cpu", **UNET),
        {"normalizer": _normalizer(["base_camera_rgb", "base_camera_depth"]).state_dict()}),
    "dp-image-per_key": lambda: (tentry.build_image_dp_policy(
        "resnet", 3, share_rgb_model=False, cameras=TWO, backbone_kw=RESNET18, device="cpu",
        **UNET), {}),
}


@pytest.fixture
def traced_init(monkeypatch):
    """The JAX script builds each backbone's flax trees by ``init`` (a
    compile: 40 s for SpUNet here) and overwrites them with the
    checkpoint's tensors; the test asserts every entry came from the
    checkpoint (equal to the seeded model's), so the trees' shapes are
    traced instead, their values zero."""
    for cls in (jspunet.SpUNet, jvit.ViT, jresnet.ResNetTorchVision, jmultivit.MultiViTModel):
        init = cls.init

        def traced(self, rngs, *args, _init=init, **kwargs):
            shapes = jax.eval_shape(lambda *a: _init(self, rngs, *a, **kwargs), *args)
            return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)

        monkeypatch.setattr(cls, "init", traced)


def _reference(policy, kw):
    return {f"policy.{k}": v for k, v in reference_state_dict(policy, **kw).items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_equals_the_jax_script_then_flax_to_torch(family, traced_init):
    policy, kw = FAMILIES[family]()
    policy = _seeded(policy)
    own = {k: v.clone() for k, v in policy.state_dict().items()}
    sd = _reference(policy, kw)
    got = tport.port_state_dict(sd)
    ref = JPORT.port_state_dict({k: v.numpy() for k, v in sd.items()}, nhead=4)
    want = flax_to_torch({"params": ref["params"], "batch_stats": ref["batch_stats"]}, policy)
    names = {n for n, _ in policy.named_parameters()}
    assert set(got["params"]) == names and set(got["batch_stats"]) == set(own) - names
    assert (got["step"], got["epoch"]) == (ref["step"], ref["epoch"]) == (0, -1)
    merged = {**got["params"], **got["batch_stats"]}
    assert set(merged) == set(want) == set(own)
    differ = [k for k in merged if not torch.equal(merged[k], want[k])
              or not torch.equal(merged[k], own[k])]
    assert not differ, differ[:5]
    assert ("extras" in got) == ("extras" in ref) == ("normalizer" in kw)
    if "normalizer" in kw:
        jx = arrays_to_tensors(jax.tree.map(np.asarray, ref["extras"]))
        assert jax.tree.structure(got["extras"]) == jax.tree.structure(jx)
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got["extras"]),
                                                     jax.tree.leaves(jx)))
    policy.load_state_dict(merged, strict=True)


def test_the_command_line_round_trip_predicts_as_jax(tmp_path, fixed_rng):  # noqa: F811
    """A fake ``.ckpt`` of the image DP (one shared ResNet-18, the tiny
    widths of ``tests/test_torch_image_dp.py``) through the command, a
    fresh module's ``Trainer.restore_checkpoint``, then ``predict`` against
    JAX's policy on the JAX script's trees and normalizer."""
    cameras, channels = ("base_camera",), 4
    jn, tn = _image_normalizers(cameras, channels)
    kw = dict(backbone_kw=RESNET18, encoder_kw=dict(resize_shape=RESIZE, crop_shape=CROP),
              device="cpu", **UNET)
    source = _seeded(tentry.build_image_dp_policy("resnet", channels, seed=3, **kw))
    ckpt = tmp_path / "reference.ckpt"
    save_lightning_ckpt(str(ckpt), reference_state_dict(source, tn.state_dict()))
    out = tmp_path / "ported"
    run = subprocess.run([sys.executable, "-m", "pointcloudmatters_tpu_torch.port_reference_ckpt",
                          str(ckpt), str(out)], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "ported" in run.stdout and (out / CHECKPOINT_FILE).exists()
    assert set(read_checkpoint(str(out))) == {"params", "batch_stats", "step", "epoch", "extras"}

    module = ManiSkill2DiffusionPolicyBCModule(
        tentry.build_image_dp_policy("resnet", channels, seed=9, **kw))
    trainer = Trainer(accelerator="cpu", seed=0)
    trainer.restore_checkpoint(str(out), module)
    assert trainer.current_epoch == 0 and trainer.global_step == 0
    for k, v in source.state_dict().items():
        assert torch.equal(module.policy.state_dict()[k], v), k
    assert module.policy.normalizer.state_dict().keys() == tn.state_dict().keys()

    item = JPORT.port_state_dict({k: v.numpy() for k, v in _reference(source, {
        "normalizer": tn.state_dict()}).items()})
    jenc, _ = _encoders("resnet", channels, True, cameras)
    jpolicy = jdp.DiffusionUnetImagePolicy(
        shape_meta=tentry.image_dp_shape_meta(channels, cameras),
        noise_scheduler=jdp.DDPMScheduler(
            num_train_timesteps=5, beta_start=0.0001, beta_end=0.02,
            beta_schedule="squaredcos_cap_v2", clip_sample=True, prediction_type="epsilon"),
        obs_encoder=jenc, normalizer=jnorm.LinearNormalizer.from_state_dict(
            item["extras"]["normalizer"]),
        horizon=8, n_action_steps=4, n_obs_steps=2, num_inference_steps=5,
        diffusion_step_embed_dim=16, down_dims=(16, 32))
    obs = tentry.build_image_dp_batch(2, IMG, channels, cameras, horizon=8, seed=4,
                                      with_actions=False)
    ref = jax.jit(lambda v, b: jpolicy.apply(v, b, train=False))(
        {"params": item["params"], "batch_stats": item["batch_stats"]},
        jax.tree.map(jnp.asarray, obs))["a_hat"]
    got = module.predict(obs, torch.Generator())
    assert got.shape == (2, 4, 7)
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4 * scale, rtol=0)
    tport.main([str(ckpt), str(tmp_path / "unused"), "--dry-run"])
    assert not (tmp_path / "unused").exists()


def _act_resnet_sd(**kw):
    return _reference(tentry.build_image_policy("resnet", 3, backbone_kw=RESNET18, **ACT_TINY),
                      kw)


@pytest.mark.parametrize("case", ["resnet-depth", "vit-width", "multivit-width"])
def test_unknown_architectures_are_refused_as_in_jax(case, traced_init):
    if case == "resnet-depth":
        sd = {k: v for k, v in _act_resnet_sd().items() if ".layer4.1." not in k}
        match = "unrecognized torchvision ResNet layout"
    elif case == "vit-width":
        sd = _reference(tentry.build_image_policy("vit", 3, backbone_kw=dict(
            model_name="vit_tiny_test", img_size=32), **ACT_TINY), {})
        match = "unrecognized ViT architecture"
    else:
        sd = _reference(tentry.build_image_policy("multivit", 4, backbone_kw=dict(
            dim_tokens=32, depth=1, num_heads=4, img_size=32), **ACT_TINY), {})
        match = "unrecognized MultiViT dim_tokens=32"
    with pytest.raises(ValueError, match=match):
        tport.port_state_dict(sd)
    with pytest.raises(ValueError, match=match):
        JPORT.port_state_dict({k: v.numpy() for k, v in sd.items()})


def test_the_state_only_act_and_an_unknown_policy_are_refused():
    """The state-only ACT's entries convert (``pos.weight`` is the port's
    ``state_pos_embed``; the family is held bit for bit above); an unknown
    ``--policy`` is refused, as by the JAX script."""
    sd = _act_resnet_sd()
    extra = {"policy.pos.weight": torch.randn(3, 32),
             "policy.input_proj_env_state.weight": torch.randn(32, 10),
             "policy.input_proj_env_state.bias": torch.randn(32)}
    got = tport.port_state_dict({**sd, **extra})["params"]
    assert torch.equal(got["state_pos_embed"], extra["policy.pos.weight"])
    assert torch.equal(got["input_proj_env_state.weight"],
                       extra["policy.input_proj_env_state.weight"])
    ref = JPORT.port_state_dict({k: v.numpy() for k, v in {**sd, **extra}.items()}, nhead=4)
    np.testing.assert_array_equal(ref["params"]["state_pos_embed"], extra["policy.pos.weight"])
    with pytest.raises(ValueError, match="unknown policy"):
        tport.port_state_dict(sd, policy="transformer")
    assert tport.port_state_dict(sd, policy="act")["params"].keys() == \
        tport.port_state_dict(sd)["params"].keys()
