"""RLBench in the port against the JAX package, on the CPU, at tiny widths.

- The four RLBench datasets (``data/components/rlbench/datasets.py``) over
  ``tests/synth.make_synthetic_rlbench`` episodes: every sample bit-equal to
  JAX's under one seed of numpy's and Python's streams (the start step, the
  grid sampling's picks, the shuffle), ``use_mask`` labelling included,
  and the streams left at the same place; the DP variants' identity
  normalizers.
- ``utils/rotation_conversions.py`` against JAX's on random quaternions,
  rotations near 180 degrees (where ``matrix_to_quaternion`` changes its
  branch) and exact ties (the first index wins, as ``jnp.argmax``): within
  2e-6 (f32 rounding of the same formulas); ``matrix_to_quaternion``'s
  gradient at a half turn is finite.
- ``ACTRLBenchPCD`` (PointNet) and ``ACTRLBench`` (a ResNet-18 at 32
  pixels) with JAX's variables carried over by ``flax_to_torch``: the
  outputs with actions (6D rotations, sigmoid gripper and collision), the
  weighted loss (``position_loss_weight`` 10) and the outputs without
  actions (quaternions) within 1e-5 of max(1, max |JAX|) (the loss 1e-5
  relative); one ``"bf16-mixed"`` step of ``ACTRLBenchPCD`` against the JAX
  ``Trainer``'s at ``tests/test_torch_bf16.py``'s limits (one tensor's gradient
  at 0.25 in place of 0.2, BF16_RELU_GRAD_TOL).
- The RLBench Diffusion Policy (11-wide actions and qpos, a 512-wide task
  embedding, the dataset's identity normalizer) on a collated batch of the
  port's RLBench DP dataset: the train-mode loss within 1e-4 relative and
  each gradient within 1e-4 of its tensor's largest entry, JAX's noise and
  timesteps on both sides (``tests/test_torch_diffusion_policy.py``'s
  ``fixed_rng``).
- ``TemporalAgg`` over a sequence of chunks bit-equal to JAX's (both numpy,
  float64 buffers).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.data.components.rlbench import datasets as jds
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act import positional_encoding as jpe
from pointcloudmatters_tpu.models.components.act.transformer import (
    Transformer as JTransformer,
    TransformerEncoder as JTransformerEncoder,
)
from pointcloudmatters_tpu.models.components.diffusion_policy import (
    diffusion_unet_image_policy as jdp,
)
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion import ddpm as jddpm
from pointcloudmatters_tpu.models.components.diffusion_policy.vision.pcd_obs_encoder import (
    PCDObsEncoder as JEncoder,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import PointNet as JPointNet
from pointcloudmatters_tpu.trainer import Trainer as JTrainer, TrainState, _cast_floating
from pointcloudmatters_tpu.utils import config as JC
from pointcloudmatters_tpu.utils import misc as jmisc
from pointcloudmatters_tpu.utils import rotation_conversions as jrc
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.data.collate import padded_pcd_collate_fn
from pointcloudmatters_tpu_torch.data.components.rlbench import datasets as tds
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.act import act as tact
from pointcloudmatters_tpu_torch.models.components.act.positional_encoding import (
    PositionEmbeddingSine,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy import (
    diffusion_unet_image_policy as tdp,
)
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import ddpm as tddpm
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.pcd_obs_encoder import (  # noqa: E501
    PCDObsEncoder,
)
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import PointNet
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import config as TC
from pointcloudmatters_tpu_torch.utils import misc as tmisc
from pointcloudmatters_tpu_torch.utils import rotation_conversions as trc
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401
from test_torch_bf16 import LR, OPT, _ZERO_GRAD, _common_patches, _rel
from test_torch_diffusion_policy import fixed_rng, one_torch_thread  # noqa: F401
from test_torch_img_encoders import backbones, init_variables
from tests.synth import make_synthetic_rlbench

TASK = "close_jar"
TRANSFORM = [
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.GridSamplePCD",
     "grid_size": 0.01, "hash_type": "fnv", "mode": "train", "return_grid_coord": True,
     "keys": ["coord", "color"]},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.NormalizeColorPCD"},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.ShufflePointPCD"},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.ToTensorPCD"},
    {"_target_": "pointcloudmatters_tpu.data.components.transformpcd.CollectPCD",
     "keys": ["coord", "grid_coord"], "feat_keys": ["color", "coord"]},
]
ACTION_DIM = 11  # xyz, 6D rotation, gripper, collision
HEAD = dict(hidden_dim=32, chunk=4, enc_layers=1, dec_layers=2, nhead=4)
GOAL_DIM = 512
# the bf16 step's gradient limits, of each tensor's largest entry: 0.2, as
# tests/test_torch_bf16.py's flagship holds, for every tensor (worst
# measured 0.18, the first decoder layer's FFN bias; 0.12 next), and 0.25
# for the one tensor above it, that layer's FFN weight (measured 0.21): it
# sits before a ReLU whose inputs bf16 rounds across zero in one package
# and not the other, and the weight's gradient is the outer product of
# that masked signal with the layer's input
BF16_GRAD_TOL = 0.2
BF16_RELU_GRAD_TOL = {"transformer.decoder.layers.0.linear1.weight": 0.25}


@pytest.fixture(scope="module")
def rlbench_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rlbench"))
    return make_synthetic_rlbench(root, task_name=TASK, n_episodes=3, episode_len=8)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

DATASETS = {
    "act_rgbd": ("RLBenchSingleTaskACTRGBDDataset", dict(include_depth=True)),
    "act_pcd": ("RLBenchSingleTaskACTPCDDataset", {}),
    # about half the synthetic labels (0-249) invalid: a mixed foreground
    "act_pcd_mask": ("RLBenchSingleTaskACTPCDDataset",
                     dict(use_mask=True, invalid_mask_values=list(range(120, 250)))),
    "dp_rgbd": ("RLBenchSingleTaskDiffusionPolicyRGBDDataset",
                dict(include_depth=True, n_obs_steps=2)),
    "dp_pcd": ("RLBenchSingleTaskDiffusionPolicyPCDDataset", dict(n_obs_steps=2)),
}


def _dataset(module, engine, root, kind, **extra):
    name, kw = DATASETS[kind]
    kw = dict(kw, root=os.path.join(root, "train"), task_names=[TASK], chunk_size=4,
              collision=True, loop=2, **extra)
    if "pcd" in kind:
        kw["transform_pcd"] = [engine.instantiate(t) for t in TRANSFORM]
    return getattr(module, name)(**kw)


def _assert_same(got, ref, path="sample"):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}[{i}]")
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.dtype == r.dtype and g.shape == r.shape, (path, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=path)


@pytest.mark.parametrize("kind", list(DATASETS))
def test_datasets_match_jax_sample_for_sample(kind, rlbench_root):
    """Each sample of each RLBench dataset equal to JAX's, both drawn from
    numpy's and Python's streams seeded alike, the streams left alike."""
    ref_ds = _dataset(jds, JC, rlbench_root, kind)
    got_ds = _dataset(tds, TC, rlbench_root, kind)
    assert len(got_ds) == len(ref_ds) == 6
    for idx in range(len(ref_ds)):
        np.random.seed(100 + idx)
        random.seed(100 + idx)
        ref = ref_ds[idx]
        after = (np.random.rand(), random.random())
        np.random.seed(100 + idx)
        random.seed(100 + idx)
        got = got_ds[idx]
        assert (np.random.rand(), random.random()) == after
        _assert_same(got, ref)
    if kind.startswith("dp"):
        ref_n, got_n = ref_ds.get_normalizer(), got_ds.get_normalizer()
        assert sorted(got_n.keys()) == sorted(ref_n.keys())
        for k in ref_n.keys():
            np.testing.assert_array_equal(np.asarray(got_n[k].scale), np.asarray(ref_n[k].scale))
            np.testing.assert_array_equal(np.asarray(got_n[k].offset),
                                          np.asarray(ref_n[k].offset))
    if kind == "act_pcd_mask":
        # the label rides in the colour channels through NormalizeColorPCD
        # (0 -> -1), so every point is labelled foreground, in JAX as here
        pcd = got["pcds"][0]
        assert pcd["mask"].dtype == bool and pcd["mask"].shape == pcd["coord"].shape[:1]
        assert pcd["feat"].shape[-1] == 6


def test_the_crop_is_strict_on_both_sides(tmp_path):
    """A point on a face of ``SCENE_BOUNDS`` is cropped away, as JAX crops it."""
    make_synthetic_rlbench(str(tmp_path), task_name=TASK, n_episodes=1, episode_len=3,
                           stages=("train",))
    ds = _dataset(tds, TC, str(tmp_path), "act_pcd", cache_episode=True)
    obs = ds.episodes[0][1]["demo"][0]
    lo, hi = np.array(tds.SCENE_BOUNDS[:3]), np.array(tds.SCENE_BOUNDS[3:])
    cloud = obs["front_point_cloud"]
    cloud[1, :3] = lo
    cloud[2, :3] = hi
    cloud[3, :3] = (lo + hi) / 2
    kept = ds._merged_cloud(obs)["coord"]
    for point, inside in ((lo, False), (hi, False), ((lo + hi) / 2, True)):
        assert (kept == point.astype(np.float32)).all(-1).any() == inside, point
    ref = _dataset(jds, JC, str(tmp_path), "act_pcd")
    np.random.seed(0)
    random.seed(0)
    want = ref._merged_cloud(obs)
    np.random.seed(0)
    random.seed(0)
    _assert_same(ds._merged_cloud(obs), want)


def test_the_port_writes_the_episodes_the_jax_tests_write(tmp_path):
    """``entry.write_rlbench_episodes`` (numpy only, for the card) writes
    the files ``tests/synth.make_synthetic_rlbench`` writes, bit for bit."""
    got = tentry.write_rlbench_episodes(str(tmp_path / "port"), n_episodes=2, episode_len=3)
    ref = make_synthetic_rlbench(str(tmp_path / "jax"), task_name=TASK, n_episodes=2,
                                 episode_len=3)
    for stage in ("train", "val"):
        for ep in range(2):
            load = [np.load(os.path.join(r, stage, TASK, f"ep{ep}.npy"), allow_pickle=True).item()
                    for r in (got, ref)]
            _assert_same(load[0], load[1])


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def _quats(n=64, seed=0):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _half_turns(seed=1):
    """Rotations within 1e-3 rad of a half turn about random axes, exact
    half turns about the coordinate axes and about (1, 1, 0) / sqrt(2) (two
    equal candidates), as matrices."""
    rng = np.random.RandomState(seed)
    axes = rng.randn(32, 3)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.pi - rng.uniform(0, 1e-3, (32, 1))
    axes = np.concatenate([axes * angles, np.pi * np.eye(3),
                           np.pi * np.array([[1, 1, 0], [0, 1, -1]]) / np.sqrt(2)])
    return np.asarray(jrc.axis_angle_to_matrix(jnp.asarray(axes, jnp.float32)))


ROTATION_FUNCTIONS = {
    "quaternion_to_matrix": lambda m, q, d6: m.quaternion_to_matrix(q),
    "matrix_to_quaternion": lambda m, q, d6: m.matrix_to_quaternion(m.quaternion_to_matrix(q)),
    "rotation_6d_to_matrix": lambda m, q, d6: m.rotation_6d_to_matrix(d6),
    "matrix_to_rotation_6d": lambda m, q, d6: m.matrix_to_rotation_6d(m.quaternion_to_matrix(q)),
    "quaternion_multiply": lambda m, q, d6: m.quaternion_multiply(q, d6[:, 2:]),
    "quaternion_invert": lambda m, q, d6: m.quaternion_invert(q),
    "quaternion_apply": lambda m, q, d6: m.quaternion_apply(q, d6[:, :3]),
    "axis_angle": lambda m, q, d6: m.axis_angle_to_quaternion(m.quaternion_to_axis_angle(q)),
    "axis_angle_to_matrix": lambda m, q, d6: m.axis_angle_to_matrix(d6[:, 3:]),
    "matrix_to_axis_angle": lambda m, q, d6: m.matrix_to_axis_angle(m.quaternion_to_matrix(q)),
    "euler_XYZ": lambda m, q, d6: m.matrix_to_euler_angles(
        m.euler_angles_to_matrix(d6[:, :3], "XYZ"), "XYZ"),
    "euler_ZXZ": lambda m, q, d6: m.matrix_to_euler_angles(
        m.euler_angles_to_matrix(d6[:, 3:], "ZXZ"), "ZXZ"),
}


@pytest.mark.parametrize("name", list(ROTATION_FUNCTIONS))
def test_rotation_conversions_match_jax(name):
    q = _quats()
    d6 = np.random.RandomState(2).randn(len(q), 6).astype(np.float32)
    fn = ROTATION_FUNCTIONS[name]
    ref = np.asarray(fn(jrc, jnp.asarray(q), jnp.asarray(d6)))
    got = fn(trc, torch.from_numpy(q), torch.from_numpy(d6)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_matrix_to_quaternion_near_a_half_turn_matches_jax():
    """Near 180 degrees the real part is ~0 and the branch moves to the
    largest of x, y, z; exact ties take the first index, as in JAX."""
    m = np.array(_half_turns())
    ref = np.asarray(jrc.matrix_to_quaternion(jnp.asarray(m)))
    got = trc.matrix_to_quaternion(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert (np.abs(ref[:, 0]) < 1e-3).all()
    q_abs = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0], [0.0, 0.0, 1.0, 1.0]])
    assert trc._first_argmax(q_abs).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(q_abs.numpy()), -1)).tolist() == [1, 0, 2]


def test_matrix_to_quaternion_gradient_is_finite_at_a_half_turn():
    m = torch.from_numpy(np.array(_half_turns())).requires_grad_()
    trc.matrix_to_quaternion(m).sum().backward()
    assert torch.isfinite(m.grad).all()
    d6 = torch.randn(8, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    trc.matrix_to_quaternion(trc.rotation_6d_to_matrix(d6)).sum().backward()
    assert torch.isfinite(d6.grad).all()


# ---------------------------------------------------------------------------
# the ACT heads
# ---------------------------------------------------------------------------

def _jax_head(kind: str):
    d = HEAD["hidden_dim"]
    common = dict(
        transformer=JTransformer(
            d_model=d, nhead=HEAD["nhead"], num_encoder_layers=HEAD["enc_layers"],
            num_decoder_layers=HEAD["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="oneshot"),
        encoder=JTransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                    num_layers=HEAD["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=HEAD["chunk"], action_dim=ACTION_DIM, qpos_dim=ACTION_DIM,
        goal_cond_dim=GOAL_DIM, kl_weight=10.0, collision=True, position_loss_weight=10.0)
    if kind == "pcd":
        return jact.ACTRLBenchPCD(backbone=JPointNet(in_channels=6, num_classes=0),
                                  num_cameras=0, pcd_nsample=4, pcd_npoints=16, **common)
    jnet, _ = backbones("resnet", 3)
    return jact.ACTRLBench(
        backbone=jnet, num_cameras=1,
        obs_feature_pos_embedding=jpe.PositionEmbeddingSine(num_pos_feats=d // 2, normalize=True),
        **common)


def _port_head(kind: str):
    d = HEAD["hidden_dim"]
    transformer, encoder = tentry._act_head(d, HEAD["enc_layers"], HEAD["dec_layers"], 32,
                                            HEAD["nhead"], 0.0)
    common = dict(transformer=transformer, encoder=encoder, hidden_dim=d,
                  num_queries=HEAD["chunk"], action_dim=ACTION_DIM, qpos_dim=ACTION_DIM,
                  goal_cond_dim=GOAL_DIM, kl_weight=10.0, rot_type="6d", collision=True,
                  position_loss_weight=10.0)
    if kind == "pcd":
        return tact.ACTRLBenchPCD(PointNet(in_channels=6, num_classes=0), pcd_nsample=4,
                                  pcd_npoints=16, **common)
    _, tnet = backbones("resnet", 3)
    return tact.ACTRLBench(tnet, num_cameras=1,
                           obs_feature_pos_embedding=PositionEmbeddingSine(d // 2, normalize=True),
                           **common)


def _head_batch(kind: str, seed: int = 0) -> dict:
    """A batch of 4 (8 images for ResNet: its last stage is 1 x 1) with
    RLBench's widths: 11-wide qpos and actions, a 512-wide goal."""
    if kind == "pcd":
        batch = tentry.build_batch(4, n_points=256, chunk=HEAD["chunk"], action_dim=ACTION_DIM,
                                   qpos_dim=ACTION_DIM, goal_dim=GOAL_DIM, seed=seed)
    else:
        batch = tentry.build_image_batch(8, 24, 3, chunk=HEAD["chunk"], action_dim=ACTION_DIM,
                                         qpos_dim=ACTION_DIM, goal_dim=GOAL_DIM, seed=seed)
    n = len(batch["qpos"])
    batch["is_pad"] = np.arange(HEAD["chunk"])[None] >= (np.arange(n) % 3 + 2)[:, None]
    return batch


@pytest.fixture(scope="module", params=["pcd", "image"])
def head_case(request):
    """JAX's outputs of one RLBench head: eval mode with actions (6D, the
    loss) and without (quaternions); one compile each."""
    kind = request.param
    batch = _head_batch(kind)
    request_batch = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    jpolicy = _jax_head(kind)
    with jax.default_prng_impl("threefry2x32"):
        jbatch = jax.tree.map(jnp.asarray, batch)
        variables = init_variables(jpolicy, jbatch, seed=7)
        variables = jax.tree.map(np.asarray, {"params": variables["params"],
                                              "batch_stats": variables.get("batch_stats", {})})
        apply = jax.jit(lambda v, b: jpolicy.apply(v, b, train=False))
        with_actions = apply(variables, jbatch)
        without = apply(variables, jax.tree.map(jnp.asarray, request_batch))
    ref = {"a_hat": np.asarray(with_actions["a_hat"]), "loss": float(with_actions["loss"]),
           "action_loss": float(with_actions["action_loss"]),
           "is_pad_hat": np.asarray(with_actions["is_pad_hat"]),
           "quat": np.asarray(without["a_hat"])}
    return dict(kind=kind, batch=batch, request=request_batch, variables=variables, ref=ref)


def _loaded_port_head(case):
    policy = _port_head(case["kind"])
    policy.load_state_dict(flax_to_torch(case["variables"], policy), strict=True)
    return policy.eval()


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def test_rlbench_heads_match_jax(head_case):
    """With actions: 6D rotations, sigmoid gripper and collision, the loss
    weighting xyz by 10 before the mean over every element; without: unit
    quaternions with a nonnegative real part."""
    policy = _loaded_port_head(head_case)
    ref = head_case["ref"]
    with torch.no_grad():
        out = policy(_to_torch(head_case["batch"]), train=False)
        served = policy(_to_torch(head_case["request"]), train=False)
    assert out["a_hat"].shape[-1] == ACTION_DIM and served["a_hat"].shape[-1] == ACTION_DIM - 2
    _close(out["a_hat"], ref["a_hat"], "a_hat (6D)")
    _close(out["is_pad_hat"], ref["is_pad_hat"], "is_pad_hat")
    for key in ("loss", "action_loss"):
        np.testing.assert_allclose(float(out[key]), ref[key], rtol=1e-5, err_msg=key)
    _close(served["a_hat"], ref["quat"], "a_hat (quaternion)")
    quat = served["a_hat"][..., 3:7]
    torch.testing.assert_close(quat.norm(dim=-1), torch.ones(quat.shape[:-1]), rtol=0, atol=1e-5)
    assert (quat[..., 0] >= 0).all()
    grip = out["a_hat"][..., -2:]
    assert ((grip > 0) & (grip < 1)).all()


def test_the_position_weight_multiplies_each_element_before_the_mean(head_case):
    """The loss is mean(w * (a_hat - a)^2 * keep) over every element, padded
    rows included, w 10 on xyz."""
    policy = _loaded_port_head(head_case)
    batch = _to_torch(head_case["batch"])
    with torch.no_grad():
        out = policy(batch, train=False)
    keep = (~batch["is_pad"])[..., None].float()
    w = torch.ones(ACTION_DIM)
    w[:3] = 10.0
    want = ((out["a_hat"] - batch["actions"]) ** 2 * w * keep).mean()
    torch.testing.assert_close(out["action_loss"], want, rtol=1e-6, atol=0)


def test_rlbench_pcd_bf16_step_matches_jax(monkeypatch, tmp_path):
    """One ``Trainer(precision="bf16-mixed")`` step of ``ACTRLBenchPCD``,
    port against JAX's ``Trainer`` from the same variables and batch, at
    ``tests/test_torch_bf16.py``'s limits but one: the loss 1e-2 relative,
    each gradient BF16_GRAD_TOL (0.2) of its tensor's largest entry but the
    one named in BF16_RELU_GRAD_TOL (0.25; the exactly-zero ones within
    5e-3 of the model's largest), the batch
    statistics 1e-3 relative + 1e-5, the masters after the AdamW step 1e-6
    where the gradient is signal, else 2 lr + 1e-6."""
    eps = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    _common_patches(monkeypatch, eps)
    batch = _head_batch("pcd", seed=3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jpolicy = _jax_head("pcd")
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(jbatch)
    variables = jax.tree.map(np.asarray, _randomize(variables, 7))
    jmodule = JBCModule(jpolicy, optimizer=OPT)
    jmodule.configure_optimizers(variables["params"], total_steps=10)
    step = JTrainer(default_root_dir=str(tmp_path), precision="bf16-mixed",
                    prng_impl=None)._build_train_step(jmodule)

    def loss_fn(params):
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

    module = BCModule(_port_head("pcd"), optimizer=OPT)
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
        if np.abs(ref).max() == 0:
            assert not p.grad.any(), name
        elif any(k in name for k in _ZERO_GRAD):
            assert max(np.abs(ref).max(), p.grad.abs().max().item()) <= 5e-3 * g_max, name
        else:
            assert _rel(p.grad, ref) < BF16_RELU_GRAD_TOL.get(name, BF16_GRAD_TOL), name
    final = flax_to_torch({"params": jax.tree.map(np.asarray, state.params),
                           "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}, target)
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


# ---------------------------------------------------------------------------
# the RLBench Diffusion Policy
# ---------------------------------------------------------------------------

DP_META = {
    "action": {"shape": [ACTION_DIM]},
    "obs": {"pcds": {"shape": [6], "type": "pcd"},
            "qpos": {"shape": [ACTION_DIM], "type": "low_dim"}},
    "goal": {"task_emb": {"shape": [GOAL_DIM]}},
}
DP_ENC = dict(n_obs_step=2, pcd_nsample=4, pcd_npoints=16, pcd_hidden_dim=32,
              projector_layers=1, projector_channels=[32, 48, 48])
DP_POLICY = dict(horizon=4, n_action_steps=2, n_obs_steps=2, num_inference_steps=5,
                 diffusion_step_embed_dim=16, down_dims=(32, 64), kernel_size=5, n_groups=8,
                 cond_predict_scale=True)
DP_SCHED = dict(num_train_timesteps=5, beta_schedule="squaredcos_cap_v2")
# biases whose shift a train-mode batch norm takes out again
DP_ZERO_GRAD = ("obs_encoder.pcd_model.final.bias", "obs_encoder.projector_conv0.bias",
                "obs_encoder.projector_out.bias")


def test_rlbench_dp_loss_and_gradients_match_jax(rlbench_root, fixed_rng):  # noqa: F811
    """The loss and every gradient on 4 collated samples of the port's
    RLBench DP dataset, with the dataset's identity normalizer on both
    sides."""
    ds = _dataset(tds, TC, rlbench_root, "dp_pcd")
    np.random.seed(0)
    random.seed(0)
    batch = padded_pcd_collate_fn([ds[i] for i in range(4)], pad_multiple=64)
    batch = {"obs": {"qpos": batch["obs"]["qpos"],
                     "pcds": {k: batch["obs"]["pcds"][k] for k in ("coord", "feat", "valid")}},
             "action": batch["action"], "goal": batch["goal"]}
    jn = jds.RLBenchSingleTaskDiffusionPolicyPCDDataset.get_normalizer(ds)
    jpolicy = jdp.DiffusionUnetImagePolicy(
        shape_meta=DP_META, noise_scheduler=jddpm.DDPMScheduler(**DP_SCHED),
        obs_encoder=JEncoder(shape_meta=DP_META, pcd_model=JPointNet(in_channels=6,
                                                                     num_classes=32), **DP_ENC),
        normalizer=jn, **DP_POLICY)
    tpolicy = tdp.DiffusionUnetImagePolicy(
        shape_meta=DP_META, noise_scheduler=tddpm.DDPMScheduler(**DP_SCHED),
        obs_encoder=PCDObsEncoder(shape_meta=DP_META, pcd_model=PointNet(in_channels=6,
                                                                         num_classes=32),
                                  **DP_ENC),
        normalizer=ds.get_normalizer(), **DP_POLICY)
    key = jax.random.PRNGKey(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda b: jpolicy.init(
        {"params": key, "noise": key, "sample": key}, b, train=True), jbatch)
    rng = np.random.RandomState(7)

    def leaf(path, x):
        if path[-1].key == "kernel":
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        return np.zeros(x.shape, np.float32)

    variables = jax.tree.map(np.asarray, _randomize(
        jax.tree_util.tree_map_with_path(leaf, shapes), 7))
    tpolicy.load_state_dict(flax_to_torch(variables, tpolicy), strict=True)

    def loss_fn(params, b):
        out, mut = jpolicy.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                                 train=True, mutable=["batch_stats"])
        return out["loss"], mut

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jbatch)
    out = tpolicy(_to_torch(batch), train=True, rngs={"noise": torch.Generator()})
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss), rtol=1e-4)
    ref = flax_to_torch({"params": jax.tree.map(np.asarray, grads),
                         "batch_stats": variables["batch_stats"]}, tpolicy)
    largest = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, p in tpolicy.named_parameters():
        r = ref[name].numpy()
        if name in DP_ZERO_GRAD or np.abs(r).max() <= 1e-6 * largest:
            assert max(np.abs(r).max(), p.grad.abs().max()) <= 1e-6 * largest, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# TemporalAgg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("apply", [True, False])
def test_temporal_agg_matches_jax(apply):
    """Fifteen chunks through a buffer of 6 (filling, full, rolling), a
    reset, and three more: every action equal to JAX's."""
    rng = np.random.RandomState(0)
    ref = jmisc.TemporalAgg(apply=apply, action_dim=5, chunk_size=6, k=0.05)
    got = tmisc.TemporalAgg(apply=apply, action_dim=5, chunk_size=6, k=0.05)
    for i in range(18):
        if i == 15 and apply:
            ref.reset()
            got.reset()
        chunk = rng.randn(6, 5).astype(np.float32)
        want = ref(chunk)
        out = got(chunk)
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out, want)
    if apply:
        assert got.action_buffer.dtype == np.float64
