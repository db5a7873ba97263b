"""SpUNet in the port (``pointcloudmatters_tpu_torch/models/components/
pcd_encoder/spunet.py``, ``models/components/pretrained.py``) against the
JAX package, on the CPU, on the same numpy inputs, with JAX's variables
carried over by ``flax_to_torch``.

Limits (f32 differs in summation order only; bf16 as
``tests/test_torch_bf16.py`` sets them):

- ``PDBatchNorm`` outputs, running statistics of every branch, and
  gradients within 1e-5 of the largest reference entry; the branches not
  selected get gradients of exactly zero on both sides;
- SpUNet at JAX's ``TINY`` widths (``tests/test_spunet.py``) on its sparse
  batch: outputs and every batch statistic within 1e-4 of the largest
  reference entry, each parameter's gradient within 1e-4 of its tensor's
  largest entry (a dozen convolutions and batch norms deep; measured
  worst 2e-6 and 1.3e-5);
- PonderV2 loading bit-equal to JAX's mapping.

ACT over SpUNet's training step and ``predict`` are in
``tests/test_torch_spunet_step.py``.
"""

import functools
import logging
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pointcloudmatters_tpu.models.components import pretrained as jpretrained
from pointcloudmatters_tpu.models.components.pcd_encoder import spunet as jspunet
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.components import pretrained as tpretrained
from pointcloudmatters_tpu_torch.models.components.pcd_encoder import spunet as tspunet
from pointcloudmatters_tpu_torch.utils import config as TC
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_spunet import TINY, make_sparse_batch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

TINY_KW = {k: tuple(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
CONFIG_DIR = str(pathlib.Path(__file__).resolve().parent.parent / "configs")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, limit, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=limit * max(1e-30, np.abs(ref).max()),
                               err_msg=what)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


# ---------------------------------------------------------------------------
# PDBatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decouple,adaptive", [(True, True), (True, False), (False, True)])
def test_pd_batch_norm_matches_jax(decouple, adaptive):
    """Train mode over a masked batch with condition "B": the output, the
    running statistics of every branch (all move, as the reference's do),
    and the gradients of the input, the context and every parameter; then
    eval mode on the statistics the step left."""
    conds = ("A", "B", "C")
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 30, 8) * 2 + 0.5).astype(np.float32)
    mask = np.arange(30)[None] < np.array([[30], [17]])
    ctx = rng.randn(1, 4).astype(np.float32)
    cot = rng.randn(2, 30, 8).astype(np.float32)
    jm = jspunet.PDBatchNorm(conditions=conds, decouple=decouple, adaptive=adaptive,
                             context_channels=4)
    args = dict(mask=jnp.asarray(mask), condition="B",
                context=jnp.asarray(ctx) if adaptive else None)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), **args), 1)

    def f(params, xx, cc):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                            **dict(args, context=cc if adaptive else None), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (ref, mut)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], jnp.asarray(x), jnp.asarray(ctx))
    tm = tspunet.PDBatchNorm(8, context_channels=4, conditions=conds, decouple=decouple,
                             adaptive=adaptive)
    tm.load_state_dict(flax_to_torch(variables, tm))
    xt, ct = _t(x).requires_grad_(), _t(ctx).requires_grad_()
    got = tm(xt, mask=_t(mask), condition="B", context=ct if adaptive else None, train=True)
    (got * _t(cot)).sum().backward()
    _close(got, ref, 1e-5, "output")
    _close(xt.grad, grads[1], 1e-5, "d x")
    if adaptive:
        _close(ct.grad, grads[2], 1e-5, "d context")
    state = tm.state_dict()
    for key, value in flax_to_torch({"params": variables["params"],
                                     "batch_stats": mut["batch_stats"]}, tm).items():
        if key.endswith((".mean", ".var")):
            _close(state[key], value, 1e-5, key)
            assert not torch.equal(state[key], _t(_flat(variables["batch_stats"])[
                tuple(re.sub(r"bns\.(\d)", r"bns_\1", key).split("."))])), key
    ref_grads = flax_to_torch({"params": grads[0], "batch_stats": mut["batch_stats"]}, tm)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, ref_grads[name], 1e-5, name)
        if decouple and re.match(r"bns\.[02]\.", name):
            assert not p.grad.any(), name  # the branches not selected: exact zeros
    eval_ref = jm.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                        jnp.asarray(x), **args, train=False)
    with torch.no_grad():
        _close(tm(_t(x), mask=_t(mask), condition="B", context=_t(ctx) if adaptive else None),
               eval_ref, 1e-5, "eval")


# ---------------------------------------------------------------------------
# SpUNet at JAX's TINY widths
# ---------------------------------------------------------------------------

VARIANTS = {"default": {}, "cls_classes": dict(cls_mode=True, num_classes=10)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def tiny(request):
    """JAX's TINY SpUNet of one variant: variables (randomised norms),
    the train-mode output, batch statistics and gradients of sum(out *
    cot), and the eval output, each compiled once a process."""
    return _tiny_reference(request.param)


@functools.cache
def _tiny_reference(variant):
    with jax.default_prng_impl("threefry2x32"):
        return _tiny_jax(VARIANTS[variant])


def _tiny_jax(kw):
    net = jspunet.SpUNet(in_channels=6, **TINY, **kw)
    d, _ = make_sparse_batch()
    variables = jax.jit(lambda b: net.init(jax.random.PRNGKey(0), b, train=True))(d)
    variables = jax.tree.map(np.asarray, _randomize(variables, 3))
    out_shape = (2, net.num_channels) if kw.get("cls_mode") else (2, 160, net.num_channels)
    cot = np.random.RandomState(5).randn(*out_shape).astype(np.float32)

    def loss(params, b):
        out, mut = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                             train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], d)
    eval_out = jax.jit(lambda v, b: net.apply(v, b, train=False))(variables, d)
    return dict(kw=kw, d={k: np.asarray(v) for k, v in d.items()}, variables=variables,
                cot=cot, out=np.asarray(out), stats=jax.tree.map(np.asarray, stats),
                grads=jax.tree.map(np.asarray, grads), eval_out=np.asarray(eval_out),
                num_channels=net.num_channels)


def _tiny_port(tiny):
    net = tspunet.SpUNet(in_channels=6, **TINY_KW, **tiny["kw"])
    net.load_state_dict(flax_to_torch(tiny["variables"], net))
    assert net.num_channels == tiny["num_channels"]
    return net


def test_tiny_spunet_train_matches_jax(tiny):
    net = _tiny_port(tiny)
    out = net({k: _t(v) for k, v in tiny["d"].items()}, train=True)
    (out * _t(tiny["cot"])).sum().backward()
    _close(out, tiny["out"], 1e-4, "output")
    state = net.state_dict()
    stats = flax_to_torch({"params": tiny["variables"]["params"], "batch_stats": tiny["stats"]},
                          net)
    n_stats = 0
    for key, value in stats.items():
        if key.endswith((".mean", ".var")):
            _close(state[key], value, 1e-4, key)
            n_stats += 1
    assert n_stats == 2 * 3 * sum(isinstance(m, tspunet.PDBatchNorm) for m in net.modules())
    ref_grads = flax_to_torch({"params": tiny["grads"], "batch_stats": tiny["stats"]}, net)
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, ref_grads[name], 1e-4, f"grad {name}")


def test_tiny_spunet_eval_matches_jax(tiny):
    net = _tiny_port(tiny).eval()
    with torch.no_grad():
        out = net({k: _t(v) for k, v in tiny["d"].items()}, train=False)
    _close(out, tiny["eval_out"], 1e-4)


def test_padding_and_condition(tiny):
    """Padded slots' features and coordinates change nothing at the valid
    slots (nothing at all in ``cls_mode``); another condition changes the
    output (its embedding differs); a condition that is no string means the
    first."""
    net = _tiny_port(tiny).eval()
    d = {k: _t(v) for k, v in tiny["d"].items()}
    valid = d["valid"]
    keep = slice(None) if tiny["kw"].get("cls_mode") else valid
    with torch.no_grad():
        base = net(d)
        junk = dict(d, feat=torch.where(valid[..., None], d["feat"], 321.0),
                    grid_coord=torch.where(valid[..., None], d["grid_coord"], 3))
        np.testing.assert_allclose(net(junk)[keep], base[keep], atol=1e-5)
        assert not torch.allclose(net(dict(d, condition="S3DIS")), base)
        assert torch.equal(net(dict(d, condition=7)), base)


# ---------------------------------------------------------------------------
# PonderV2 weights from a local file
# ---------------------------------------------------------------------------

def _fake_ponderv2(net: nn.Module, seed: int) -> dict:
    """A PonderV2-like state dict for ``net``'s widths: the keys and spconv
    (out, k, k, k, in) shapes of ``to_ponderv2_state_dict``, random values,
    and an extra key both mappings ignore."""
    rng = np.random.RandomState(seed)
    sd = {"module.backbone.unused.weight": torch.zeros(3)}
    for key, value in tspunet.to_ponderv2_state_dict(net).items():
        arr = rng.rand(*value.shape) + 0.5 if key.endswith("running_var") else rng.randn(
            *value.shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    return sd


def test_ponderv2_weights_load_like_jax(tmp_path):
    """A fake PonderV2 file (``{"state_dict": ...}``): the port's
    ``load_pretrained_into`` against JAX's ``_load_torch_file`` +
    ``load_ponderv2_weights`` from the same initial variables, every entry
    bit-equal; each plane is the file's tensor permuted from spconv's
    layout."""
    net = jspunet.SpUNet(in_channels=6, **TINY)
    variables = _tiny_reference("default")["variables"]
    path = str(tmp_path / "ponderv2.pth")
    tnet = tspunet.SpUNet(in_channels=6, **TINY_KW, pretrained_path=path)
    tnet.load_state_dict(flax_to_torch(variables, tnet))
    sd = _fake_ponderv2(tnet, 0)
    torch.save({"state_dict": sd, "epoch": 3}, path)
    params, stats = jspunet.load_ponderv2_weights(
        dict(variables["params"]), dict(variables["batch_stats"]),
        jpretrained._load_torch_file(path), conditions=net.conditions)
    ref = flax_to_torch({"params": params, "batch_stats": stats}, tnet)
    assert tpretrained.load_pretrained_into(tnet) is tnet
    for key, value in tnet.state_dict().items():
        assert torch.equal(value, ref[key]), key
    w = sd["module.backbone.enc.1.block0.conv2.weight"].numpy()  # (out, 3, 3, 3, in)
    np.testing.assert_array_equal(tnet.enc1_block0_conv2.detach().numpy(),
                                  w.reshape(w.shape[0], 27, w.shape[-1]).transpose(1, 2, 0))
    exported = tspunet.to_ponderv2_state_dict(tnet)  # the inverse, back to the file
    assert all(torch.equal(v, sd[k]) for k, v in exported.items())


def test_missing_pretrained_file_keeps_the_weights(tmp_path, caplog):
    tnet = tspunet.SpUNet(in_channels=6, **TINY_KW,
                          pretrained_path=str(tmp_path / "none" / "ponderv2.pth"))
    tentry.init_parameters(tnet, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        tpretrained.load_pretrained_into(tnet)
    assert "not found; keeping random init" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in tnet.state_dict().items())


def test_other_pretrained_families_raise(tmp_path):
    path = tmp_path / "r3m.pth"
    torch.save({"w": torch.zeros(1)}, path)
    encoder = nn.Linear(2, 2)
    encoder.pretrained_path = str(path)
    with pytest.raises(NotImplementedError, match="no pretrained-weight family for Linear"):
        tpretrained.load_pretrained_into(nn.Sequential(encoder))


def test_spunet_planes_draw_like_jax():
    """``init_parameters``: the planes a truncated normal of std 0.02 cut at
    two of it (flax's ``truncated_normal(0.02)``), ``final_bias`` zero, the
    condition embedding std 1/sqrt(256) as flax's ``Embed``."""
    net = tspunet.SpUNet(in_channels=6, num_classes=4, **TINY_KW)
    tentry.init_parameters(net, torch.Generator().manual_seed(0))
    planes = torch.cat([p.reshape(-1) for n, p in net.named_parameters(recurse=False)
                        if n != "final_bias"])
    assert planes.abs().max() <= 0.04 and 0.016 < planes.std() < 0.019
    assert not net.final_bias.any()
    assert 0.05 < net.embedding_table.weight.std() < 0.075


# ---------------------------------------------------------------------------
# the configs that name SpUNet
# ---------------------------------------------------------------------------

SPUNET = "pointcloudmatters_tpu.models.components.pcd_encoder.spunet.SpUNet"
FAMILIES = {"exp_maniskill2_act_policy": "maniskill2", "exp_maniskill2_diffusion_policy":
            "maniskill2", "exp_rlbench_act_policy": "rlbench",
            "exp_rlbench_diffusion_policy": "rlbench"}


def _spunet_configs():
    out = []
    for family, bench in sorted(FAMILIES.items()):
        for path in sorted((pathlib.Path(CONFIG_DIR) / family / f"{bench}_model").glob("*.yaml")):
            if SPUNET in path.read_text():
                out.append((family, bench, path.stem))
    return out


CONFIGS = _spunet_configs()
# the RLBench SpUNet configs' parameters (scratch and PonderV2 alike), JAX's
RLBENCH_SPUNET_PARAMS = {"act": 67_693_292, "dp": 314_058_059}


def test_eighteen_configs_name_spunet():
    assert len(CONFIGS) == 18
    assert sum(b == "maniskill2" for _, b, _ in CONFIGS) == 14


def _compose(family, bench, model, tmp_path):
    overrides = [f"{family}=base", f"{family}/{bench}_model@{bench}_model={model}",
                 f"hydra.run.dir={tmp_path}"]
    if bench == "maniskill2":
        overrides.append(f"{family}/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0")
    cfg = TC.compose(CONFIG_DIR, "train", overrides)
    TC.set_runtime(output_dir=str(tmp_path), cwd=str(tmp_path))
    return TC.resolve_config(cfg)


@pytest.mark.parametrize("family,bench,model", CONFIGS, ids=lambda v: str(v))
def test_spunet_configs_build_in_the_port(family, bench, model, tmp_path, monkeypatch):
    """Each config that names SpUNet, ManiSkill2's and RLBench's, composes
    and instantiates its policy at the shipped widths (on the meta device:
    shapes, no memory, no forward), its SpUNet the port's with the config's
    widths; the RLBench ones with JAX's parameter counts
    (``RLBENCH_SPUNET_PARAMS``, which ``tests/test_torch_config.py`` holds
    against JAX's traced ``init``)."""
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = _compose(family, bench, model, tmp_path)
    with torch.device("meta"):
        module = TC.instantiate(cfg.model)
    if bench == "rlbench":
        kind = "act" if "act" in family else "dp"
        assert sum(p.numel() for p in module.policy.parameters()) == RLBENCH_SPUNET_PARAMS[kind]
    nets = [m for m in module.policy.modules() if isinstance(m, tspunet.SpUNet)]
    assert len(nets) == 1
    net = nets[0]
    assert net.in_channels == (3 if model.endswith(("wo_rgb", "wo_xyz")) else 6)
    assert net.channels == (32, 64, 128, 256, 256, 128, 96, 96)
    assert net.num_classes == (512 if "presample" in model and "act" in family else 0)
    if "ponderv2" in model and (bench, "diffusion" in family) == ("rlbench", True):
        # the RLBench DP config names the reference's relative path
        assert net.pretrained_path == ("checkpoints/ponderv2-ppt-pretrain-scannet-s3dis-"
                                       "structured3d.pth")
    elif "ponderv2" in model:
        assert net.pretrained_path == f"{tmp_path}/.ponderv2/ponderv2.pth"
    else:
        assert net.pretrained_path is None
