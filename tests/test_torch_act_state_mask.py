"""The rest of the ACT surface against the JAX package, on the CPU: the
state-only ACT (no backbone; JAX ``act.py:86-92, 197-207``) and
``ACTPCD(use_mask=True)`` (JAX ``act.py:289-303``).

- The state-only ACT at the widths of ``tests/test_ckpt_port.py``'s (hidden
  64, 4 heads, 2 + 2 layers, chunk 8, ``env_state_dim`` 5), with and
  without a goal: ``predict`` and the held-out loss (its CVAE posterior's KL
  included, as in JAX) within 1e-5 of JAX's on the same randomised
  variables; a training step runs and reaches every parameter but the
  decoder's dead layers. The converter's ``pos.weight`` /
  ``input_proj_env_state.*`` go bit for bit where the JAX script followed
  by ``flax_to_torch`` puts them (``tests/test_torch_ckpt_port.py`` holds
  the family with the others).
- ``use_mask``: the token centres of the shared builder
  (``nn_utils.fps_indices``) index for index JAX's ``_fps_indices`` on
  foreground masks where point 0 is background, with fewer foreground
  points than ``n_fg`` (indices repeat) and with none (index 0 throughout),
  at ``bg_ratio`` 0 and 0.25; and the whole ``predict`` within 1e-4 of
  JAX's (a dozen f32 layers, as ``tests/test_torch_act_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act import transformer as jtr
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.trainer import Trainer
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

HID, NHEAD, FFN, CHUNK, ADIM, QDIM, EDIM = 64, 4, 32, 8, 7, 9, 5


def _jax_state_act(goal_dim):
    return jact.ACT(
        backbone=None,
        transformer=jtr.Transformer(d_model=HID, nhead=NHEAD, num_encoder_layers=2,
                                    num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0,
                                    normalize_before=False, return_intermediate_dec=True),
        encoder=jtr.TransformerEncoder(d_model=HID, nhead=8, dim_feedforward=FFN,
                                       num_layers=2, dropout=0.0),
        hidden_dim=HID, num_queries=CHUNK, num_cameras=0, action_dim=ADIM, qpos_dim=QDIM,
        env_state_dim=EDIM, goal_cond_dim=goal_dim, kl_weight=10.0)


def _batch(goal_dim, seed=0):
    batch = tentry.build_state_batch(3, env_state_dim=EDIM, chunk=CHUNK, action_dim=ADIM,
                                     qpos_dim=QDIM, goal_dim=max(goal_dim, 1), seed=seed)
    batch["is_pad"] = np.arange(CHUNK)[None].repeat(3, 0) >= CHUNK - 2
    if not goal_dim:
        del batch["goal_cond"]
    return batch


@pytest.mark.parametrize("goal_dim", [0, 3])
def test_state_only_act_predicts_and_scores_as_jax(goal_dim):
    batch = _batch(goal_dim)
    jm = _jax_state_act(goal_dim)
    variables = jax.jit(lambda b: jm.init({"params": jax.random.PRNGKey(0),
                                           "vae": jax.random.PRNGKey(1)}, b, train=False))(
        jax.tree.map(jnp.asarray, batch))
    variables = _randomize(variables, 4)
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    ref_pred = np.asarray(JBCModule(jm).predict(variables, jax.tree.map(jnp.asarray, obs)))
    ref = jm.apply(variables, jax.tree.map(jnp.asarray, batch), train=False)

    policy = tentry.build_state_policy(env_state_dim=EDIM, hidden_dim=HID, chunk=CHUNK,
                                       enc_layers=2, dec_layers=2, ffn=FFN, action_dim=ADIM,
                                       qpos_dim=QDIM, goal_dim=goal_dim, nhead=NHEAD,
                                       dropout=0.0, device="cpu")
    assert policy.state_pos_embed.shape == (2 + int(goal_dim > 0), HID)
    module = BCModule(policy)
    module.load_variables(variables)
    got_pred = module.predict(obs)
    assert got_pred.shape == (3, CHUNK, ADIM)
    np.testing.assert_allclose(got_pred.numpy(), ref_pred, atol=1e-5, rtol=0)
    out = module.apply_eval(batch)
    for key in ("loss", "action_loss", "kl_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), atol=1e-5, rtol=1e-6,
                                   err_msg=key)
    assert float(out["kl_loss"]) > 0  # the posterior's KL enters, as in JAX


def test_state_only_act_trains():
    policy = tentry.build_state_policy(env_state_dim=EDIM, hidden_dim=HID, chunk=CHUNK,
                                       enc_layers=2, dec_layers=2, ffn=FFN, nhead=NHEAD,
                                       device="cpu")
    module = BCModule(policy, optimizer={"type": "AdamW", "lr": 1e-3})
    batch = {k: torch.as_tensor(v) for k, v in _batch(3, seed=2).items()}
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    Trainer(accelerator="cpu").train_step(module, batch)
    moved = {k for k, v in policy.state_dict().items() if not torch.equal(v, before[k])}
    assert {"state_pos_embed", "input_proj_env_state.weight", "cls_embed"} <= moved
    assert "additional_pos_embed" in moved  # AdamW's decay reaches the unused table
    with pytest.raises(ValueError, match="env_state_dim"):
        tentry.build_state_policy(env_state_dim=0, device="cpu")


# ---------------------------------------------------------------------------
# use_mask
# ---------------------------------------------------------------------------

N_PTS, NPOINTS = 96, 16


def _masked_cloud(case, rng):
    coord = (rng.rand(2, N_PTS, 3) * 0.4 - 0.2).astype(np.float32)
    valid = np.arange(N_PTS)[None] < np.array([[N_PTS], [70]])
    fg = rng.rand(2, N_PTS) < 0.5
    fg[:, 0] = False  # point 0 is background: FPS still seeds there
    if case == "few":
        fg[:] = False
        fg[0, [5, 9, 40]] = True
        fg[1, [3, 66]] = True
    elif case == "none":
        fg[:] = False
    return coord, valid, fg


@pytest.mark.parametrize("bg_ratio", [0.0, 0.25])
@pytest.mark.parametrize("case", ["background_at_0", "few", "none"])
def test_masked_fps_matches_jax(case, bg_ratio):
    coord, valid, fg = _masked_cloud(case, np.random.RandomState(3))
    jm = jentry.build_flagship(hidden_dim=32, npoints=NPOINTS, nsample=4, chunk=5, enc_layers=1,
                               dec_layers=1, nhead=4).clone(use_mask=True, bg_ratio=bg_ratio)
    # setup needs the variables' structure, not their values
    batch = jax.tree.map(jnp.asarray, jentry.build_batch(batch_size=2, n_points=N_PTS, chunk=5))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "vae": jax.random.PRNGKey(0)}, batch))
    variables = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
    ref = np.asarray(jm.apply(variables, jnp.asarray(coord), jnp.asarray(valid),
                              jnp.asarray(fg), method=jact.ACTPCD._fps_indices))
    got = tnn.fps_indices(torch.from_numpy(coord), torch.from_numpy(valid), NPOINTS,
                          torch.from_numpy(fg), bg_ratio)
    np.testing.assert_array_equal(got.numpy(), ref)
    n_fg = NPOINTS - int(NPOINTS * bg_ratio)
    if case == "none":
        assert (ref[:, :n_fg] == 0).all()
    if case == "few":
        assert len(set(ref[0, :n_fg])) <= 4  # 3 foreground points and the seed


@pytest.mark.parametrize("bg_ratio", [0.0, 0.25])
def test_masked_actpcd_predicts_as_jax(bg_ratio):
    dims = dict(hidden_dim=32, npoints=NPOINTS, nsample=4, chunk=5, enc_layers=1,
                dec_layers=2, nhead=4)
    batch = jentry.build_batch(batch_size=2, n_points=N_PTS, chunk=5)
    batch["pcds"]["mask"] = np.random.RandomState(5).rand(2, N_PTS) < 0.4
    batch["pcds"]["mask"][:, 0] = False
    policy = jentry.build_flagship(**dims).clone(use_mask=True, bg_ratio=bg_ratio)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: policy.init({"params": rng, "vae": rng, "dropout": rng}, b,
                                              train=True))(jax.tree.map(jnp.asarray, batch))
    variables = _randomize(variables, 6)
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    ref = np.asarray(JBCModule(policy).predict(variables, jax.tree.map(jnp.asarray, obs)))
    module = BCModule(tentry.build_flagship(**dims, use_mask=True, bg_ratio=bg_ratio,
                                            device="cpu"))
    module.load_variables(variables)
    np.testing.assert_allclose(module.predict(obs).numpy(), ref, atol=1e-4, rtol=1e-4)
    # the DP's encoder shares the builder
    from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision import (
        pcd_obs_encoder,
    )
    assert pcd_obs_encoder.group_tokens is tnn.group_tokens
