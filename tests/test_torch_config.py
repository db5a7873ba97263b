"""The port's config composer (``pointcloudmatters_tpu_torch/utils/config.py``)
against the JAX package's: over the flagship family (the six
``scratch_pointnet_pcd*`` models x the eight ManiSkill2 point-cloud tasks,
and ``trainer=cpu``, ``debug=default``, ``debug=fdr``, ``logger=csv``) the
composed, resolved configs are equal (both keep the configs' targets), and
every target resolves in the port, through the prefix map
``pointcloudmatters_tpu.`` -> ``pointcloudmatters_tpu_torch.``, to the
counterpart of the JAX object.
The compositions build in the port (model at full width, data, trainer,
callbacks, loggers); a target the port lacks raises ``NotImplementedError``
naming ROADMAP; an ``ImportError`` inside a module propagates as itself.
The card has PyYAML, so the port reads YAML with ``yaml.safe_load`` as the
JAX composer does and has no reader of its own to test.
"""

import importlib
import pathlib
import sys

import pytest
import torch

from pointcloudmatters_tpu.utils import config as JC
from pointcloudmatters_tpu_torch import callbacks as tcallbacks
from pointcloudmatters_tpu_torch import loggers as tloggers
from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
from pointcloudmatters_tpu_torch.models.maniskill2_modules import ManiSkill2ACTBCModule
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils import config as TC
from pointcloudmatters_tpu_torch.utils.utils import instantiate_callbacks, instantiate_loggers
from tests.synth import make_synthetic_maniskill2

CONFIG_DIR = str(pathlib.Path(__file__).resolve().parent.parent / "configs")
FAMILY = "exp_maniskill2_act_policy"
MODELS = sorted(p.stem for p in (pathlib.Path(CONFIG_DIR) / FAMILY / "maniskill2_model")
                .glob("scratch_pointnet_pcd*.yaml"))
TASKS = sorted(p.stem for p in (pathlib.Path(CONFIG_DIR) / FAMILY / "maniskill2_pcd_task")
               .glob("*.yaml"))
EXTRAS = (["trainer=cpu"], ["debug=default"], ["debug=fdr"], ["logger=csv"])
FLAGSHIP_PARAMS = 24_124_456


def _overrides(model, task, extra=(), out="/out"):
    return [f"{FAMILY}=base",
            f"{FAMILY}/maniskill2_model@maniskill2_model={model}",
            f"{FAMILY}/maniskill2_pcd_task@maniskill2_pcd_task={task}",
            f"hydra.run.dir={out}", f"hydra.sweep.dir={out}/sweep", *extra]


def _compose(engine, overrides, out="/out"):
    cfg = engine.compose(CONFIG_DIR, "train", overrides)
    engine.set_runtime(output_dir=out, cwd="/cwd")
    return engine.resolve_config(cfg)


def _targets(tree):
    if isinstance(tree, dict):
        if isinstance(dict.get(tree, "_target_"), str):
            yield dict.__getitem__(tree, "_target_")
        for v in dict.values(tree):
            yield from _targets(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _targets(v)


@pytest.fixture(autouse=True)
def _project_root(monkeypatch, tmp_path):
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))


def _check_composition(overrides):
    """Equal compositions; equal resolutions, or the same error where the
    JAX composer cannot resolve (the NullGoal tasks retarget
    ``data.train``, which drops the ``chunk_size`` that ``model`` reads);
    every target located in the port as the counterpart of JAX's."""
    ref, got = JC.compose(CONFIG_DIR, "train", overrides), TC.compose(CONFIG_DIR, "train",
                                                                      overrides)
    # the configs keep the JAX package's targets; the port maps them where
    # it locates them
    assert TC.to_container(got) == JC.to_container(ref)
    for engine in (JC, TC):
        engine.set_runtime(output_dir="/out", cwd="/cwd")
    try:
        JC.resolve_config(ref)
    except KeyError as err:
        with pytest.raises(KeyError) as port_err:
            TC.resolve_config(got)
        assert str(port_err.value) == str(err)
    else:
        assert TC.to_container(TC.resolve_config(got)) == JC.to_container(ref)
    targets = sorted(set(_targets(ref)))
    assert targets and all(t.startswith("pointcloudmatters_tpu.") for t in targets)
    for target in targets:
        jobj, tobj = JC._locate(target), TC._locate(target)
        assert tobj.__qualname__ == jobj.__qualname__, target
        assert tobj.__module__ == jobj.__module__.replace(
            "pointcloudmatters_tpu", "pointcloudmatters_tpu_torch", 1), target


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("model", MODELS)
def test_composition_equals_jax_once_targets_map(model, task):
    _check_composition(_overrides(model, task))


@pytest.mark.parametrize("extra", EXTRAS, ids=lambda e: e[0])
def test_composition_with_run_overrides_equals_jax(extra):
    _check_composition(_overrides("scratch_pointnet_pcd", "PickCube-v0", extra))


DP_FAMILY = "exp_maniskill2_diffusion_policy"
DP_MODELS = sorted(p.stem for p in (pathlib.Path(CONFIG_DIR) / DP_FAMILY / "maniskill2_model")
                   .glob("scratch_pointnet_pcd*.yaml"))


@pytest.mark.parametrize("model", DP_MODELS)
def test_the_diffusion_policy_composes_and_resolves_to_the_port(model):
    """The Diffusion Policy's point-cloud compositions: equal to JAX's, and
    every target (the task module, the policy, the DDPM scheduler, the
    encoder, the dataset) the port's counterpart of JAX's."""
    overrides = [f"{DP_FAMILY}=base", f"{DP_FAMILY}/maniskill2_model@maniskill2_model={model}",
                 f"{DP_FAMILY}/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
                 "hydra.run.dir=/out"]
    _check_composition(overrides)
    targets = set(_targets(JC.to_container(JC.compose(CONFIG_DIR, "train", overrides))))
    assert {"pointcloudmatters_tpu.models.maniskill2_modules.ManiSkill2DiffusionPolicyBCModule",
            "pointcloudmatters_tpu.models.components.diffusion_policy.diffusion.ddpm."
            "DDPMScheduler"} <= targets
    assert len(DP_MODELS) == 6


def test_the_family_is_the_one_the_port_trains():
    assert len(MODELS) == 6 and len(TASKS) == 8, (MODELS, TASKS)


@pytest.fixture(scope="module")
def demo_file(tmp_path_factory):
    return make_synthetic_maniskill2(str(tmp_path_factory.mktemp("cfg") / "demo.h5"),
                                     n_episodes=2, episode_len=6, cam_side=8)


@pytest.mark.parametrize("model", MODELS)
def test_composition_builds_in_the_port(model, demo_file, tmp_path):
    """The model at the published width, the datamodule over a demo file,
    the trainer, callbacks and (CSV) loggers: the port's classes."""
    cfg = _compose(TC, _overrides(model, "PickCube-v0", [
        "logger=csv", "debug=default", f"data.train.dataset_file={demo_file}",
        f"data.train.cache_dir={tmp_path}/cache", "data.train.point_num_per_cam=64"],
        out=str(tmp_path)), out=str(tmp_path))
    module = TC.instantiate(cfg.model)
    assert type(module) is ManiSkill2ACTBCModule
    policy = module.policy
    assert type(policy).__module__ == "pointcloudmatters_tpu_torch.models.components.act.act"
    assert (policy.hidden_dim, policy.num_queries, policy.pcd_npoints, policy.pcd_nsample) \
        == (512, 100, 2048, 16)
    assert policy.pre_sample == ("presample" in model)
    assert policy.backbone.in_channels == (3 if model.endswith(("wo_rgb", "wo_xyz")) else 6)
    if model == "scratch_pointnet_pcd":
        assert sum(p.numel() for p in policy.parameters()) == FLAGSHIP_PARAMS
    data = TC.instantiate(cfg.data)
    assert type(data) is BaseDataModule and len(data.data_train) > 0
    assert type(data.data_val).__name__ == "DummyDataset"
    assert [type(t).__name__ for t in data.data_train.transform_pcd.transforms] == [
        "GridSamplePCD", "NormalizeColorPCD", "ShufflePointPCD", "ToTensorPCD", "CollectPCD"]
    callbacks = instantiate_callbacks(cfg.callbacks)
    assert [type(c) for c in callbacks] == [
        tcallbacks.ModelCheckpoint, tcallbacks.ModelSummary, tcallbacks.RichProgressBar,
        tcallbacks.LearningRateMonitor, tcallbacks.DeviceStatsMonitor]
    loggers = instantiate_loggers(cfg.logger)
    assert [type(lg) for lg in loggers] == [tloggers.CSVLogger]
    trainer = TC.instantiate(cfg.trainer, callbacks=callbacks, logger=loggers)
    assert type(trainer) is Trainer and trainer.accelerator == "cpu"
    assert trainer.accumulate_grad_batches == 2 and trainer.precision == "bf16-mixed"
    assert trainer.checkpoint_callback is callbacks[0]


IMAGE_MODELS = sorted(p.stem for p in (pathlib.Path(CONFIG_DIR) / FAMILY / "maniskill2_model")
                      .glob("*.yaml") if "img_encoder" in p.read_text())
DP_IMAGE_MODELS = sorted(p.stem for p in (pathlib.Path(CONFIG_DIR) / DP_FAMILY / "maniskill2_model")
                         .glob("*.yaml") if "img_encoder" in p.read_text())
RESNET50_PARAMS, VIT_B16_PARAMS, MULTIVIT_B_PARAMS = 23_508_032, 85_798_656, 85_843_200


def _image_overrides(model, family=FAMILY, out="/out"):
    """An image model of ``family`` with PickCube-v0: the RGB-D task, or the
    point-cloud task for a pointmap."""
    task = "maniskill2_pcd_task" if "pointmap" in model else "maniskill2_task"
    return [f"{family}=base", f"{family}/maniskill2_model@maniskill2_model={model}",
            f"{family}/{task}@{task}=PickCube-v0", f"hydra.run.dir={out}",
            f"hydra.sweep.dir={out}/sweep"]


def test_the_image_configs_are_the_twelve():
    assert len(IMAGE_MODELS) == 12 and len(DP_IMAGE_MODELS) == 12, (IMAGE_MODELS,
                                                                     DP_IMAGE_MODELS)


@pytest.mark.parametrize("model", IMAGE_MODELS)
def test_image_composition_equals_jax(model):
    """The ACT image configs compose and resolve as JAX's, and every target
    (ACT, the backbone, the sine embedding, the RGB-D or point-cloud
    dataset) is the port's counterpart."""
    _check_composition(_image_overrides(model))


@pytest.mark.parametrize("model", IMAGE_MODELS)
def test_image_composition_builds_in_the_port(model, demo_file, tmp_path, monkeypatch):
    """The policy at the published width (on the meta device) with the
    config's backbone and channels, and the datamodule over a demo file,
    whose samples carry the image the backbone takes."""
    monkeypatch.setenv("HOME", str(tmp_path))
    extra = [f"data.train.dataset_file={demo_file}", f"data.train.cache_dir={tmp_path}/cache"]
    if "pointmap" in model:
        extra.append("data.train.point_num_per_cam=64")
    cfg = _compose(TC, _image_overrides(model, out=str(tmp_path)) + extra, out=str(tmp_path))
    with torch.device("meta"):
        module = TC.instantiate(cfg.model)
    policy = module.policy
    assert type(policy).__name__ == "ACT" and type(module) is ManiSkill2ACTBCModule
    assert (policy.hidden_dim, policy.num_queries, policy.num_cameras) == (512, 100, 1)
    net = policy.backbone
    channels = (1 if "depth_only" in model else 4 if "rgbd" in model
                else 6 if "pointmap" in model else 3)
    extra_in = channels - 3  # the stem or patch kernel's inflation
    want = {"multivit": ("MultiViTModel", MULTIVIT_B_PARAMS),
            "multimae": ("MultiViTModel", MULTIVIT_B_PARAMS),
            "resnet50": ("ResNetTorchVision", RESNET50_PARAMS + 64 * 49 * extra_in),
            "r3m": ("R3MResNet", RESNET50_PARAMS),
            "vit": ("ViT", VIT_B16_PARAMS + 768 * 256 * extra_in),
            "vc1": ("VC1ViT", VIT_B16_PARAMS)}
    kind = next(k for k in want if k in model)
    assert (type(net).__name__, sum(p.numel() for p in net.parameters())) == want[kind]
    assert policy.freeze_backbone == model.startswith(("pretrained_r3m", "pretrained_vc1"))
    data = TC.instantiate(cfg.data)
    sample = data.data_train[0]
    assert sample["image"].shape[-1] == channels and sample["image"].ndim == 4
    assert type(data.data_train).__name__ == (
        "ManiSkill2GoalPosSingleTaskACTPCDDataset" if "pointmap" in model
        else "ManiSkill2GoalPosSingleTaskACTRGBDDataset")


@pytest.mark.parametrize("model", DP_IMAGE_MODELS)
def test_image_dp_composition_equals_jax(model):
    """The Diffusion Policy's image configs compose and resolve as JAX's,
    and every target (the task module, the policy, the image encoder, the
    backbone, the RGB-D or point-cloud dataset) is the port's counterpart."""
    _check_composition(_image_overrides(model, DP_FAMILY))


def _jax_param_count(cfg) -> int:
    """The JAX policy's parameters, from its ``init`` traced (not compiled)
    over one sample of its ``shape_meta``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    policy = JC.instantiate(cfg.model.policy)
    meta = cfg.model.policy.shape_meta
    obs = {}
    for key, attr in meta["obs"].items():
        kind = attr.get("type", "low_dim")
        if kind in ("rgb", "depth"):
            obs[key] = jnp.zeros((1, 2, 16, 16, min(attr["shape"])))
        elif kind == "low_dim":
            obs[key] = jnp.zeros((1, 16, attr["shape"][0]))
    batch = {"obs": obs, "action": jnp.zeros((1, 16, meta["action"]["shape"][0])),
             "goal": {"task_emb": jnp.zeros((1, meta["goal"]["task_emb"]["shape"][0]))}}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: policy.init(
        {"params": key, "noise": key, "crop": key, "dropout": key}, b, train=True), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("model", DP_IMAGE_MODELS)
def test_image_dp_composition_builds_in_the_port(model, demo_file, tmp_path, monkeypatch):
    """The image DP at the published width (on the meta device): the
    config's backbone, channels and encoder, JAX's parameter count (the
    UNet's condition (backbone width + 9) x 2 + 3 wide), the DP task
    module; and the datamodule over a demo file, whose samples carry the
    frames the encoder takes."""
    monkeypatch.setenv("HOME", str(tmp_path))
    extra = [f"data.train.dataset_file={demo_file}", f"data.train.cache_dir={tmp_path}/cache"]
    if "pointmap" in model:
        extra.append("data.train.point_num_per_cam=64")
    cfg = _compose(TC, _image_overrides(model, DP_FAMILY, out=str(tmp_path)) + extra,
                   out=str(tmp_path))
    with torch.device("meta"):
        module = TC.instantiate(cfg.model)
    policy = module.policy
    assert type(module).__name__ == "ManiSkill2DiffusionPolicyBCModule"
    assert type(policy).__module__ == ("pointcloudmatters_tpu_torch.models.components."
                                       "diffusion_policy.diffusion_unet_image_policy")
    enc = policy.obs_encoder
    assert type(enc).__name__ == "MultiImageObsEncoder" and enc.share_rgb_model
    assert (enc.resize_shape, enc.crop_shape, enc.random_crop) == ((256, 256), (224, 224), False)
    net = enc.rgb_model
    kinds = {"multivit": "MultiViTModel", "multimae": "MultiViTModel", "resnet50":
             "ResNetTorchVision", "r3m": "R3MResNet", "vit": "ViT", "vc1": "VC1ViT"}
    assert type(net).__name__ == kinds[next(k for k in kinds if k in model)]
    width = 2048 if "resnet" in type(net).__name__.lower() else 768
    assert policy.global_cond_dim == (width + 9) * 2 + 3
    jcfg = _compose(JC, _image_overrides(model, DP_FAMILY, out=str(tmp_path)) + extra,
                    out=str(tmp_path))
    assert sum(p.numel() for p in policy.parameters()) == _jax_param_count(jcfg)
    data = TC.instantiate(cfg.data)
    sample = data.data_train[0]["obs"]
    channels = (6 if "pointmap" in model else 1 if "depth_only" in model else
                4 if "rgbd" in model else 3)
    rgb = sample["base_camera_rgb"]
    assert rgb.ndim == 4 and rgb.shape[0] == 2 and rgb.shape[-1] == (6 if channels == 6 else 3)
    assert ("base_camera_depth" in sample) == (channels in (1, 4))
    assert type(data.data_train).__name__ == (
        "ManiSkill2GoalPosSingleTaskDiffusionPolicyPCDDataset" if "pointmap" in model
        else "ManiSkill2GoalPosSingleTaskDiffusionPolicyRGBDDataset")


RLBENCH_FAMILIES = ("exp_rlbench_act_policy", "exp_rlbench_diffusion_policy")
RLBENCH_CONFIGS = [(family, p.stem) for family in RLBENCH_FAMILIES
                   for p in sorted((pathlib.Path(CONFIG_DIR) / family / "rlbench_model")
                                   .glob("*.yaml"))]


def _rlbench_overrides(family, model, out="/out"):
    return [f"{family}=base", f"{family}/rlbench_model@rlbench_model={model}",
            "rlbench_task=close_jar", f"hydra.run.dir={out}", f"hydra.sweep.dir={out}/sweep"]


def _jax_rlbench_param_count(cfg, family) -> int:
    """The JAX policy's parameters, from its ``init`` traced (not compiled)
    over one small sample of the composition's inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    policy = JC.instantiate(cfg.model.policy)
    n = 4096  # points a cloud, above the configs' 2048 tokens
    cloud = {"coord": jnp.zeros((2, n, 3)), "feat": jnp.zeros((2, n, 6)),
             "valid": jnp.ones((2, n), bool), "grid_coord": jnp.zeros((2, n, 3), jnp.int32)}
    key = jax.random.PRNGKey(0)
    if "diffusion" in family:
        meta, obs = cfg.model.policy.shape_meta, {}
        for name, attr in meta["obs"].items():
            kind = attr.get("type", "low_dim")
            if kind in ("rgb", "depth"):
                obs[name] = jnp.zeros((1, 2, 16, 16, min(attr["shape"])))
            elif kind == "low_dim":
                obs[name] = jnp.zeros((1, 16, attr["shape"][0]))
            else:
                obs[name] = cloud
        batch = {"obs": obs, "action": jnp.zeros((1, 16, meta["action"]["shape"][0])),
                 "goal": {"task_emb": jnp.zeros((1, 512))}}
    else:
        nq, ad = cfg.model.policy.num_queries, cfg.model.policy.action_dim
        batch = {"qpos": jnp.zeros((1, ad)), "actions": jnp.zeros((1, nq, ad)),
                 "is_pad": jnp.zeros((1, nq), bool), "goal_cond": jnp.zeros((1, 512))}
        if "pcd" in cfg.model.policy._target_.lower():
            batch["pcds"] = jax.tree.map(lambda a: a[:1], cloud)
        else:
            batch["image"] = jnp.zeros((1, 1, 224, 224, 4 if cfg.data.train.include_depth
                                        else 3))
    rngs = {name: key for name in ("params", "vae", "dropout", "mask", "noise", "crop")}
    shapes = jax.eval_shape(lambda b: policy.init(rngs, b, train=True), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))


def test_the_rlbench_model_configs_are_the_twenty_two():
    assert len(RLBENCH_CONFIGS) == 22
    assert sum(f == RLBENCH_FAMILIES[0] for f, _ in RLBENCH_CONFIGS) == 11


@pytest.mark.parametrize("family,model", RLBENCH_CONFIGS, ids=lambda v: str(v))
def test_rlbench_composition_equals_jax_and_builds(family, model, tmp_path, monkeypatch):
    """Each RLBench model config (ACT's and the Diffusion Policy's, 11 each)
    composes and resolves as JAX's, every target the port's counterpart;
    its task module builds on the meta device at the shipped width with
    JAX's parameter count (``pretrained_multimae_rgbd`` of the DP keeps the
    reference's ``task_name``)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    _check_composition(_rlbench_overrides(family, model))
    cfg = _compose(TC, _rlbench_overrides(family, model, out=str(tmp_path)), out=str(tmp_path))
    with torch.device("meta"):
        module = TC.instantiate(cfg.model)
    act = family == RLBENCH_FAMILIES[0]
    assert type(module).__name__ == ("RLBenchACTBCModule" if act
                                     else "RLBenchDiffusionPolicyBCModule")
    want = ("ACTRLBenchPCD" if "pcd" in model else "ACTRLBench") if act \
        else "DiffusionUnetImagePolicy"
    assert type(module.policy).__name__ == want
    if act:
        policy = module.policy
        assert (policy.rot_type, policy.collision, policy.position_loss_weight,
                policy.goal_cond_dim) == ("6d", True, 10.0, 512)
    jcfg = _compose(JC, _rlbench_overrides(family, model, out=str(tmp_path)), out=str(tmp_path))
    assert sum(p.numel() for p in module.policy.parameters()) == _jax_rlbench_param_count(
        jcfg, family)


@pytest.mark.parametrize("target", [
    "pointcloudmatters_tpu.models.components.nn_utils.FrozenBatchNorm",
    "pointcloudmatters_tpu.models.components.act.transformer.EfficientMHA",
    "pointcloudmatters_tpu.models.components.diffusion_policy.diffusion."
    "transformer_for_diffusion.TransformerForDiffusion",
])
def test_a_target_the_port_lacks_raises(target):
    with pytest.raises(NotImplementedError, match=rf"{target} is not ported yet.*ROADMAP"):
        TC._locate(target)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TC.instantiate({"_target_": target})


def test_a_target_outside_the_package_is_left_as_it_is():
    assert TC._locate("collections.OrderedDict") is importlib.import_module(
        "collections").OrderedDict
    with pytest.raises(ImportError, match="Cannot locate target"):
        TC._locate("collections.NoSuchThing")


def test_an_import_error_inside_a_module_propagates(tmp_path, monkeypatch):
    (tmp_path / "pcm_cfg_broken.py").write_text("import pcm_cfg_no_such_package\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError) as err:
        TC._locate("pcm_cfg_broken.Thing")
    assert err.value.name == "pcm_cfg_no_such_package"
    sys.modules.pop("pcm_cfg_broken", None)

    real = importlib.import_module

    def missing_h5py(name, *args):
        if name == "pointcloudmatters_tpu_torch.data.components.maniskill2":
            raise ModuleNotFoundError("No module named 'h5py'", name="h5py")
        return real(name, *args)

    monkeypatch.setattr(TC.importlib, "import_module", missing_h5py)
    with pytest.raises(ModuleNotFoundError) as err:
        TC._locate("pointcloudmatters_tpu.data.components.maniskill2."
                   "ManiSkill2GoalPosSingleTaskACTPCDDataset")
    assert err.value.name == "h5py"


def test_multirun_expands_as_jax(tmp_path):
    for overrides in (["seed=1,2", "model.policy.hidden_dim=32"], ["a=1,2", "b=x,y"],
                      ["k=[1,2]", "s='a,b'"], ["trainer=cpu,default", "~x"]):
        assert TC.expand_multirun(overrides) == JC.expand_multirun(overrides)


def test_cli_values_parse_as_in_the_jax_composer():
    for text in ("1e-4", "[a, b]", "null", "'x,y'", "{a: 1}", "true", "0.1", "${a.b}",
                 "epoch={epoch:03d}", "val/loss", "[goal_pos]"):
        assert TC._parse_cli_value(text) == JC._parse_cli_value(text)
