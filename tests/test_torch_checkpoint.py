"""The port's checkpoints (``Trainer.save_checkpoint`` /
``restore_checkpoint``, ``fit(ckpt_path=)``, ``validate(ckpt_path=)``):

- a round trip is bit-equal in every parameter, running statistic,
  optimizer moment, schedule step, gradient mean and generator state, with
  and without ``weights_only``, for k = 1 and k = 2, saved mid-accumulation
  after an odd count of micro-steps; one step after the restore (dropout on)
  equals the step the saved trainer takes next, bit for bit;
- a JAX checkpoint (Orbax, written by the JAX ``ModelCheckpoint`` after one
  epoch with k = 2 over 5 micro-batches, so that a gradient mean is open)
  converted by ``flax_to_torch.jax_checkpoint_to_torch`` and resumed by the
  port's ``fit`` matches the JAX ``fit(ckpt_path=)`` of the next epoch
  within ``tests/test_torch_fit.py``'s limits: parameters, batch statistics,
  the optimizer's moments, logged losses and the schedule's learning rates.
"""

import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pointcloudmatters_tpu.callbacks import ModelCheckpoint as JModelCheckpoint
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components import pretrained as jpretrained
from pointcloudmatters_tpu.trainer import Trainer as JTrainer
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
    ManiSkill2ACTBCModule,
    ManiSkill2DiffusionPolicyBCModule,
)
from pointcloudmatters_tpu_torch.trainer import (
    CHECKPOINT_FILE,
    Trainer,
    read_checkpoint,
    write_checkpoint,
)
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch, jax_checkpoint_to_torch
from test_torch_act_slice import threefry_prng  # noqa: F401
from test_torch_fit import (  # noqa: F401
    DIMS,
    OPT,
    SCHED,
    Record,
    _datamodule,
    _fit_kwargs,
    _jax_policy,
    _jax_state,
    _read_csv,
    _torch_state,
    files,
    fixed_noise,
)
from test_torch_training import _ZERO_GRAD

SMALL = dict(DIMS, npoints=8)
TOTAL_STEPS = 10


def _batches(n):
    return [tentry.build_batch(batch_size=2, n_points=64, chunk=DIMS["chunk"], seed=s)
            for s in range(n)]


def _module(seed):
    return BCModule(tentry.build_flagship(**SMALL, seed=seed, device="cpu"), optimizer=OPT,
                    lr_scheduler=SCHED)


def _trainer(k, seed=0):
    return Trainer(accelerator="cpu", accumulate_grad_batches=k, seed=seed)


def _state(trainer, module):
    """Everything a checkpoint should carry, as CPU tensors and Python
    values."""
    policy = module.policy
    out = {f"sd/{k}": v.clone() for k, v in policy.state_dict().items()}
    opt = module.optimizer.state_dict()
    for i, st in opt["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = v.clone()
    out["groups"] = [{k: v for k, v in g.items() if k != "params"} for g in opt["param_groups"]]
    out["schedule"] = module.scheduler.last_epoch
    mean = module.gradient_mean
    if mean is not None:
        out["mini_step"] = mean.mini_step
        for i, a in enumerate(mean.acc or []):
            out[f"acc/{i}"] = a.clone()
    for k, g in trainer.rngs.items():
        out[f"rng/{k}"] = g.get_state()
    out["step"], out["epoch"] = trainer.global_step, trainer.current_epoch
    return out


def _assert_equal(got, ref, keys=None):
    keys = sorted(ref) if keys is None else keys
    for k in keys:
        if isinstance(ref[k], torch.Tensor):
            assert torch.equal(got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("weights_only", [False, True])
def test_round_trip_is_bit_equal(k, weights_only, tmp_path):
    """3 micro-steps (k = 2: one optimizer step and a mean of one gradient
    open), save, restore into another module and trainer, then one more
    step on each: bit-equal."""
    batches = _batches(4)
    module, trainer = _module(0), _trainer(k, seed=7)
    trainer.setup(module, TOTAL_STEPS)
    for b in batches[:3]:
        trainer.train_step(module, b)
    trainer.current_epoch = 1
    saved = _state(trainer, module)
    assert k == 1 or saved["mini_step"] == 1
    path = tmp_path / "ckpt"
    trainer.save_checkpoint(str(path), weights_only=weights_only)
    assert os.listdir(path) == [CHECKPOINT_FILE]
    ckpt = read_checkpoint(str(path))
    assert set(ckpt) == ({"params", "batch_stats", "step", "epoch"} if weights_only else
                         {"params", "batch_stats", "step", "epoch", "opt_state", "rng"})
    assert (ckpt["step"], ckpt["epoch"]) == (3, 1)
    assert set(ckpt["params"]) == {n for n, _ in module.policy.named_parameters()}
    assert all(n.endswith((".mean", ".var")) for n in ckpt["batch_stats"])

    other, fresh = _module(1), _trainer(k, seed=8)
    fresh.setup(other, TOTAL_STEPS)
    untouched = _state(fresh, other)
    fresh.restore_checkpoint(str(path), other)
    assert (fresh.current_epoch, fresh.global_step) == (2, 3)
    restored = _state(fresh, other)
    sd_keys = [key for key in saved if key.startswith("sd/")]
    _assert_equal(restored, saved, sd_keys)
    if weights_only:
        rest = [key for key in untouched if not key.startswith("sd/")
                and key not in ("step", "epoch")]
        _assert_equal(restored, untouched, rest)
        return
    _assert_equal(restored, saved, [key for key in saved if key not in ("step", "epoch")])

    # the next micro-step (dropout 0.1) from both: bit-equal
    trainer.train_step(module, batches[3])
    fresh.train_step(other, batches[3])
    after, after_restored = _state(trainer, module), _state(fresh, other)
    _assert_equal(after_restored, after, [key for key in after if key != "epoch"])
    assert not all(torch.equal(after[key], saved[key]) for key in sd_keys)


def test_extras_round_trip_and_the_normalizer_raises(tmp_path):
    """Extras round-trip; a normalizer in them is kept as it is by the ACT
    modules, as JAX's base module keeps it, and rebuilt on the policy by the
    Diffusion Policy's module, which raises on one that lacks its arrays."""
    module, trainer = _module(0), _trainer(1)
    trainer.setup(module, TOTAL_STEPS)
    module._extras["note"] = {"value": torch.arange(3)}
    trainer.save_checkpoint(str(tmp_path / "c"))
    other = _module(1)
    _trainer(1).restore_checkpoint(str(tmp_path / "c"), other)
    assert torch.equal(other.state_dict_extras()["note"]["value"], torch.arange(3))
    state = {"action": {"scale": torch.full((7,), 2.0), "offset": torch.zeros(7),
                        "input_stats": {}}}
    other.load_state_dict_extras({"normalizer": state})
    act = ManiSkill2ACTBCModule(_module(2).policy)
    act.load_state_dict_extras({"normalizer": state})
    assert other.state_dict_extras()["normalizer"] is state
    assert act.state_dict_extras()["normalizer"] is state
    dp = ManiSkill2DiffusionPolicyBCModule(
        tentry.build_dp_policy(npoints=8, nsample=4, hidden_dim=16, num_classes=16,
                               projector_channels=(16, 16, 16), diffusion_step_embed_dim=8,
                               down_dims=(8, 16), device="cpu"))
    dp.load_state_dict_extras({"normalizer": state})
    np.testing.assert_array_equal(dp.policy.normalizer["action"].scale, np.full(7, 2.0))
    with pytest.raises(KeyError, match="scale"):
        dp.load_state_dict_extras({"normalizer": {"action": {}}})


def test_checkpoint_replaces_the_one_there(tmp_path):
    write_checkpoint(str(tmp_path / "c"), {"step": 1})
    write_checkpoint(str(tmp_path / "c"), {"step": 2})
    assert read_checkpoint(str(tmp_path / "c")) == {"step": 2}
    assert os.listdir(tmp_path / "c") == [CHECKPOINT_FILE]


def test_restore_refuses_another_accumulation(tmp_path):
    module, trainer = _module(0), _trainer(2)
    trainer.setup(module, TOTAL_STEPS)
    trainer.save_checkpoint(str(tmp_path / "c"))
    other, fresh = _module(0), _trainer(1)
    fresh.setup(other, TOTAL_STEPS)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        fresh.restore_checkpoint(str(tmp_path / "c"), other)


def test_validate_restores_before_validating(files, tmp_path):
    """``validate(ckpt_path=)`` of a module with other weights gives the
    held-out loss of the checkpoint's weights."""
    module, trainer = _module(0), _trainer(1)
    trainer.setup(module, TOTAL_STEPS)
    trainer.save_checkpoint(str(tmp_path / "c"))
    data = _datamodule(False, files, str(tmp_path / "cache"))
    np.random.seed(0)
    ref = Trainer(accelerator="cpu", limit_val_batches=2).validate(module, data)
    np.random.seed(0)
    got = Trainer(accelerator="cpu", limit_val_batches=2).validate(
        _module(5), data, ckpt_path=str(tmp_path / "c"))
    assert got == ref and np.isfinite(ref["val/loss"])


def test_resume_from_a_converted_jax_checkpoint_matches_jax(files, tmp_path, monkeypatch,
                                                            fixed_noise):
    """k = 2, 5 micro-batches an epoch: JAX fits epoch 0 and saves ``last``;
    JAX resumes it for epoch 1, and the port resumes the same checkpoint,
    converted, for epoch 1."""
    n_train = 5
    initial = {}

    def capture(policy, variables):
        initial.update(jax.tree.map(np.asarray, variables))
        return variables

    monkeypatch.setattr(jpretrained, "load_pretrained_into", capture)
    ckpt_dir = tmp_path / "jax_ckpt"
    jtrainer = JTrainer(**{**_fit_kwargs(n_train, tmp_path, "jax"), "max_epochs": 1,
                           "logger": None},
                        callbacks=[JModelCheckpoint(dirpath=str(ckpt_dir), save_last=True)],
                        prng_impl=None)
    np.random.seed(0)
    jtrainer.fit(JBCModule(_jax_policy(), optimizer=OPT, lr_scheduler=SCHED),
                 _datamodule(True, files, str(tmp_path / "jax_cache")))
    last = str(ckpt_dir / "last")
    raw = ocp.PyTreeCheckpointer().restore(last)
    assert int(raw["step"]) == n_train and int(raw["epoch"]) == 0

    # JAX: a fresh module resumed from ``last`` for epoch 1
    jrec = Record(_jax_state)
    jmodule = JBCModule(_jax_policy(), optimizer=OPT, lr_scheduler=SCHED)
    jresume = JTrainer(**_fit_kwargs(n_train, tmp_path, "jax"), callbacks=[jrec],
                       prng_impl=None)
    np.random.seed(1)
    jresume.fit(jmodule, _datamodule(True, files, str(tmp_path / "jax_cache")), ckpt_path=last)

    # the port: the same checkpoint converted, resumed by fit
    rec = Record(_torch_state)
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu"),
                      optimizer=OPT, lr_scheduler=SCHED)
    module.load_variables(initial)
    trainer = Trainer(**_fit_kwargs(n_train, tmp_path, "torch"), callbacks=[rec])
    # the converter reads the parameter groups of a module set up alike; the
    # module that resumes is a fresh one, as JAX's is
    template = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, device="cpu"),
                        optimizer=OPT, lr_scheduler=SCHED)
    Trainer(accelerator="cpu", accumulate_grad_batches=2).setup(template, 2 * (n_train // 2))
    converted = jax_checkpoint_to_torch(raw, template)
    assert "rng" not in converted
    assert converted["opt_state"]["gradient_mean"]["mini_step"] == 1
    assert converted["opt_state"]["scheduler"] == {"last_epoch": 2}
    write_checkpoint(str(tmp_path / "port_ckpt"), converted)
    np.random.seed(1)
    trainer.fit(module, _datamodule(False, files, str(tmp_path / "torch_cache")),
                ckpt_path=str(tmp_path / "port_ckpt"))

    assert trainer.global_step == jresume.global_step == 2 * n_train
    assert module.scheduler.last_epoch == 5 and module.gradient_mean.mini_step == 0
    assert len(rec.epochs) == len(jrec.epochs) == 1 and len(rec.val) == len(jrec.val) == 1
    (got_m, got), (ref_m, ref) = rec.epochs[0], jrec.epochs[0]
    assert set(got_m) == set(ref_m)
    for key in ref_m:
        if key != "samples_per_sec":
            np.testing.assert_allclose(got_m[key], ref_m[key], rtol=1e-4, atol=0, err_msg=key)
    lr_sum = sum(module.scheduler.lr_at(s) for s in range(5))
    ref = flax_to_torch(ref, module.policy)
    for name, r in ref.items():
        r = r.numpy()
        if name.endswith((".mean", ".var")):
            atol = 1e-5
        elif any(k in name for k in _ZERO_GRAD):
            atol = 4.0 * lr_sum
        else:
            atol = 2e-6 + 1e-4 * np.abs(r).max()
        np.testing.assert_allclose(got[name].numpy(), r, atol=atol, rtol=0, err_msg=name)

    # the optimizer's moments after the epoch, JAX's converted alike
    ref_opt = jax_checkpoint_to_torch(
        {"params": jresume.state.params, "batch_stats": jresume.state.batch_stats,
         "opt_state": jresume.state.opt_state, "step": 0, "epoch": 0},
        module)["opt_state"]["optimizer"]["state"]
    for i, (name, _) in enumerate(module.policy.named_parameters()):
        st = module.optimizer.state[module.optimizer.param_groups[0]["params"][i]]
        assert float(st["step"]) == float(ref_opt[i]["step"]) == 5.0
        for key in ("exp_avg", "exp_avg_sq"):
            r = ref_opt[i][key].numpy()
            np.testing.assert_allclose(st[key].numpy(), r, rtol=0,
                                       atol=1e-6 + 1e-3 * np.abs(r).max(),
                                       err_msg=f"{name} {key}")

    # learning rates: the schedule of the resumed optimizer steps, and the
    # rate the next step would apply, against the JAX schedule
    for s in range(2, 6):
        np.testing.assert_allclose(module.scheduler.lr_at(s), float(jmodule.schedule(s)),
                                   rtol=1e-5)
    np.testing.assert_allclose(module.optimizer.param_groups[0]["lr"],
                               float(jmodule.schedule(5)), rtol=1e-5)
    # the logged rows of the resumed epoch: the same steps and losses
    rows, jrows = (_read_csv(tmp_path / name / "metrics.csv") for name in ("torch", "jax"))
    assert [r["step"] for r in rows] == [r["step"] for r in jrows]
    assert int(rows[0]["step"]) == n_train + 1
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow)
        for key in jrow:
            if jrow[key] and key not in ("step", "samples_per_sec"):
                np.testing.assert_allclose(float(row[key]), float(jrow[key]), rtol=1e-4,
                                           err_msg=key)
