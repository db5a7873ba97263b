"""The port runs without JAX: with ``jax``, ``flax``, ``optax`` and ``orbax``
blocked from import,
the package and every module of the serving and training slices import, a
tiny ``predict``, a tiny f32 training step, tiny ``"bf16-mixed"`` steps
of the frozen-backbone and ``pre_sample`` variants, a tiny ``predict``
and dropout-0 step of the ``attention_impl="fused"`` encoder through its
fused op, a tiny ``predict`` and dropout-0.1 step of the
``attention_impl="flash"`` encoder through its flash op, a tiny ACT over
SpUNet's ``predict`` and ``"bf16-mixed"`` step, a tiny
Diffusion Policy's ``predict`` and f32 and bf16 steps, and a tiny ACT over
images' (ResNet-18, MultiViT) run, a tiny image Diffusion Policy's
``predict`` and steps and a reference checkpoint of it through the
converter (``tools/reference_ckpt.py``, ``port_reference_ckpt``), and
nothing of
the JAX package (``pointcloudmatters_tpu``) was imported (the GPU machine
has no JAX); the training entry point composes ``configs/`` and fits with
JAX blocked, and RLBench's ACT trains from ``configs/`` and is evaluated by
``test_rlbench_act`` against a fake task with JAX blocked; SWA from
``configs/``, the state-only and masked ACT, ``TransformerForDiffusion``, the
timm-style builder, the schedulers and the library point ops run with JAX
blocked; ``preprocess_rlbench`` writes episodes from a fake ``rlbench``, which
the RLBench dataset reads, and a per-key unpooled image encoder sizes itself
and encodes, with JAX blocked. Every CUDA source under ``csrc/`` is one the build compiles,
and none includes a PyTorch or JAX header."""

import ast
import os
import subprocess
import sys
import textwrap

import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

SLICE_MODULES = (
    "pointcloudmatters_tpu_torch",
    "pointcloudmatters_tpu_torch._build",
    "pointcloudmatters_tpu_torch.ops",
    "pointcloudmatters_tpu_torch.ops.pointops",
    "pointcloudmatters_tpu_torch.ops.fps",
    "pointcloudmatters_tpu_torch.ops.knn",
    "pointcloudmatters_tpu_torch.ops.knn_chunkskip",
    "pointcloudmatters_tpu_torch.ops.knn_baseline",
    "pointcloudmatters_tpu_torch.ops.oneshot_attention",
    "pointcloudmatters_tpu_torch.ops.fused_builder",
    "pointcloudmatters_tpu_torch.ops.fused_mha",
    "pointcloudmatters_tpu_torch.ops.flash_attention",
    "pointcloudmatters_tpu_torch.ops.attention",
    "pointcloudmatters_tpu_torch.models.components.nn_utils",
    "pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet",
    "pointcloudmatters_tpu_torch.ops.sparse",
    "pointcloudmatters_tpu_torch.models.components.pcd_encoder.spunet",
    "pointcloudmatters_tpu_torch.models.components.pretrained",
    "pointcloudmatters_tpu_torch.models.components.act.positional_encoding",
    "pointcloudmatters_tpu_torch.models.components.act.transformer",
    "pointcloudmatters_tpu_torch.models.components.act.act",
    "pointcloudmatters_tpu_torch.utils.flax_to_torch",
    "pointcloudmatters_tpu_torch.models.bc_module",
    "pointcloudmatters_tpu_torch.models.components.loss.misc",
    "pointcloudmatters_tpu_torch.utils.optimizer",
    "pointcloudmatters_tpu_torch.utils.scheduler",
    "pointcloudmatters_tpu_torch.utils.metrics",
    "pointcloudmatters_tpu_torch.trainer",
    "pointcloudmatters_tpu_torch.entry",
    "pointcloudmatters_tpu_torch.utils.io",
    "pointcloudmatters_tpu_torch.utils.loggers",
    "pointcloudmatters_tpu_torch.data.native",
    "pointcloudmatters_tpu_torch.data.collate",
    "pointcloudmatters_tpu_torch.data.loader",
    "pointcloudmatters_tpu_torch.data.base_datamodule",
    "pointcloudmatters_tpu_torch.data.components.transformpcd",
    "pointcloudmatters_tpu_torch.data.components.misc",
    "pointcloudmatters_tpu_torch.data.components.maniskill2",
    "pointcloudmatters_tpu_torch.models.maniskill2_modules",
    "pointcloudmatters_tpu_torch.utils.config",
    "pointcloudmatters_tpu_torch.utils.pylogger",
    "pointcloudmatters_tpu_torch.utils.dist",
    "pointcloudmatters_tpu_torch.utils.utils",
    "pointcloudmatters_tpu_torch.callbacks",
    "pointcloudmatters_tpu_torch.loggers",
    "pointcloudmatters_tpu_torch.train",
    "pointcloudmatters_tpu_torch.validate",
    "pointcloudmatters_tpu_torch.utils.normalizer",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.ddpm",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.mask_generator",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion.conditional_unet1d",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.pcd_obs_encoder",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion_unet_image_policy",
    "pointcloudmatters_tpu_torch.utils.image",
    "pointcloudmatters_tpu_torch.models.components.img_encoder.resnet",
    "pointcloudmatters_tpu_torch.models.components.img_encoder.vit",
    "pointcloudmatters_tpu_torch.models.components.img_encoder.multivit",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.multi_image_obs_encoder",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision.crop_randomizer",
    "pointcloudmatters_tpu_torch.port_reference_ckpt",
    "tools.reference_ckpt",
    "pointcloudmatters_tpu_torch.utils.rotation_conversions",
    "pointcloudmatters_tpu_torch.utils.misc",
    "pointcloudmatters_tpu_torch.utils.rlbench_utils",
    "pointcloudmatters_tpu_torch.utils.profiling",
    "pointcloudmatters_tpu_torch.data.components.rlbench",
    "pointcloudmatters_tpu_torch.data.components.rlbench.constants",
    "pointcloudmatters_tpu_torch.data.components.rlbench.datasets",
    "pointcloudmatters_tpu_torch.envs",
    "pointcloudmatters_tpu_torch.envs.rollout",
    "pointcloudmatters_tpu_torch.envs.rlbench_eval",
    "pointcloudmatters_tpu_torch.envs.custom_maniskill2",
    "pointcloudmatters_tpu_torch.test_rlbench_act",
    "pointcloudmatters_tpu_torch.test_rlbench_dp",
    "pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion."
    "transformer_for_diffusion",
    "pointcloudmatters_tpu_torch.preprocess_rlbench",
    "tools.fake_rlbench",
    "tools.jax_form",
)
BLOCKED = ("jax", "flax", "optax", "orbax")


def test_port_imports_and_predicts_without_jax():
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        from pointcloudmatters_tpu_torch.entry import build_batch, build_flagship
        from pointcloudmatters_tpu_torch.models.bc_module import BCModule
        module = BCModule(build_flagship(hidden_dim=32, npoints=8, nsample=4,
                                         chunk=5, enc_layers=1, dec_layers=2,
                                         nhead=4, device="cpu"))
        a_hat = module.predict(build_batch(batch_size=1, n_points=64, chunk=5,
                                           with_actions=False))
        assert tuple(a_hat.shape) == (1, 5, 7), a_hat.shape
        from pointcloudmatters_tpu_torch.trainer import Trainer
        metrics = Trainer(seed=0).train_step(
            module, build_batch(batch_size=2, n_points=64, chunk=5))
        assert bool(metrics["loss"].isfinite()), metrics
        for variant in ({{"freeze_backbone": True}}, {{"pre_sample": True}}):
            module = BCModule(build_flagship(hidden_dim=32, npoints=8, nsample=4,
                                             chunk=5, enc_layers=1, dec_layers=2,
                                             nhead=4, device="cpu", **variant))
            metrics = Trainer(precision="bf16-mixed", seed=0).train_step(
                module, build_batch(batch_size=2, n_points=64, chunk=5))
            assert bool(metrics["loss"].isfinite()), (variant, metrics)
        from pointcloudmatters_tpu_torch.entry import build_grid_batch
        spunet = dict(base_channels=8, channels=(8, 16, 16, 16, 16, 16, 12, 12),
                      layers=(1,) * 8)
        module = BCModule(build_flagship(hidden_dim=32, npoints=8, nsample=4, chunk=5,
                                         enc_layers=1, dec_layers=2, nhead=4,
                                         backbone="spunet", spunet=spunet, device="cpu"))
        a_hat = module.predict(build_grid_batch(1, n_points=64, chunk=5, side=10,
                                                with_actions=False))
        assert tuple(a_hat.shape) == (1, 5, 7), a_hat.shape
        metrics = Trainer(precision="bf16-mixed", seed=0).train_step(
            module, build_grid_batch(2, n_points=64, chunk=5, side=10))
        assert bool(metrics["loss"].isfinite()), metrics
        from pointcloudmatters_tpu_torch.models.components.act import transformer
        calls, op = [], transformer.fused_mha
        transformer.fused_mha = lambda *a: calls.append(1) or op(*a)
        module = BCModule(build_flagship(hidden_dim=32, npoints=512, nsample=4,
                                         chunk=5, enc_layers=1, dec_layers=2,
                                         nhead=4, dropout=0.0, attention_impl="fused",
                                         device="cpu"))
        a_hat = module.predict(build_batch(batch_size=1, n_points=600, chunk=5,
                                           with_actions=False))
        assert tuple(a_hat.shape) == (1, 5, 7) and len(calls) == 1, calls
        metrics = Trainer(precision="bf16-mixed", seed=0).train_step(
            module, build_batch(batch_size=2, n_points=600, chunk=5))
        assert bool(metrics["loss"].isfinite()) and len(calls) == 2, (calls, metrics)
        from pointcloudmatters_tpu_torch.ops import attention
        calls, op = [], attention.flash_attention
        attention.flash_attention = lambda *a, **k: calls.append(k["dropout_rate"]) or op(*a, **k)
        module = BCModule(build_flagship(hidden_dim=32, npoints=1024, nsample=4,
                                         chunk=5, enc_layers=1, dec_layers=2,
                                         nhead=4, attention_impl="flash",
                                         device="cpu"))
        a_hat = module.predict(build_batch(batch_size=1, n_points=1100, chunk=5,
                                           with_actions=False))
        assert tuple(a_hat.shape) == (1, 5, 7) and calls == [0.0], calls
        metrics = Trainer(seed=0).train_step(
            module, build_batch(batch_size=2, n_points=2048, chunk=5))
        assert bool(metrics["loss"].isfinite()) and calls == [0.0, 0.1], (calls, metrics)
        import os, tempfile
        from tests.synth import make_synthetic_maniskill2
        from pointcloudmatters_tpu_torch.data.base_datamodule import BaseDataModule
        from pointcloudmatters_tpu_torch.data.components import transformpcd as T
        from pointcloudmatters_tpu_torch.data.components.maniskill2 import (
            ManiSkill2GoalPosSingleTaskACTPCDDataset)
        from pointcloudmatters_tpu_torch.data.components.misc import DummyDataset
        from pointcloudmatters_tpu_torch.models.maniskill2_modules import ManiSkill2ACTBCModule
        with tempfile.TemporaryDirectory() as tmp:
            path = make_synthetic_maniskill2(os.path.join(tmp, "demo.h5"), n_episodes=2,
                                             episode_len=6, cam_side=16)
            transforms = [T.GridSamplePCD(grid_size=0.02, return_grid_coord=True,
                                          keys=("coord", "color")),
                          T.NormalizeColorPCD(), T.ShufflePointPCD(), T.ToTensorPCD(),
                          T.CollectPCD(keys=("coord", "grid_coord"),
                                       feat_keys=("color", "coord"))]
            data = ManiSkill2GoalPosSingleTaskACTPCDDataset(
                path, goal_cond_keys=["goal_pos"], chunk_size=5, transform_pcd=transforms,
                point_num_per_cam=256, cache_dir=tmp, loop=4)
            module = ManiSkill2ACTBCModule(
                build_flagship(hidden_dim=32, npoints=8, nsample=4, chunk=5, enc_layers=1,
                               dec_layers=2, nhead=4, device="cpu"),
                optimizer={{"type": "AdamW", "lr": 1e-3}},
                lr_scheduler={{"scheduler": {{"type": "OneCycleLR", "max_lr": 1e-3}}}})
            trainer = Trainer(default_root_dir=tmp, accelerator="cpu", precision="bf16-mixed",
                              accumulate_grad_batches=2, max_epochs=1, limit_train_batches=4)
            trainer.fit(module, BaseDataModule(train=data, val=DummyDataset(4),
                                               batch_size_train=2, num_workers=2,
                                               pad_multiple=64))
        assert trainer.global_step == 4 and module.scheduler.last_epoch == 2
        assert module.train_metrics.compute()["train/loss"].isfinite()
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_diffusion_policy_predicts_and_trains_without_jax():
    """With jax, flax, optax and orbax blocked: a tiny Diffusion Policy
    module predicts (the whole reverse chain) and takes an f32 and a
    ``"bf16-mixed"`` step, and nothing of the JAX package was imported."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import torch
        from pointcloudmatters_tpu_torch.entry import build_dp_batch, build_dp_policy
        from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
            ManiSkill2DiffusionPolicyBCModule)
        from pointcloudmatters_tpu_torch.trainer import Trainer
        for precision in ("32-true", "bf16-mixed"):
            module = ManiSkill2DiffusionPolicyBCModule(build_dp_policy(
                npoints=8, nsample=4, hidden_dim=16, num_classes=16,
                projector_channels=(16, 16, 16), diffusion_step_embed_dim=8,
                down_dims=(8, 16), num_inference_steps=4, num_train_timesteps=4,
                device="cpu"))
            action = module.predict(build_dp_batch(1, n_points=64, with_actions=False),
                                    torch.Generator().manual_seed(0))
            assert tuple(action.shape) == (1, 8, 7), action.shape
            metrics = Trainer(precision=precision, seed=0).train_step(
                module, build_dp_batch(2, n_points=64))
            assert bool(metrics["loss"].isfinite()), metrics
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    # one torch thread: beside the other test processes, tiny convolutions
    # on every core run many times slower
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_image_policy_predicts_and_trains_without_jax():
    """With jax, flax, optax and orbax blocked: ACT over a tiny ResNet-18 on
    RGB-D and over a tiny MultiViT predicts and takes an f32 and a
    ``"bf16-mixed"`` step, and nothing of the JAX package was imported."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import torch
        from pointcloudmatters_tpu_torch.entry import build_image_batch, build_image_policy
        from pointcloudmatters_tpu_torch.models.bc_module import BCModule
        from pointcloudmatters_tpu_torch.trainer import Trainer
        for backbone, kw in (("resnet", dict(resnet_model="resnet18", resize_to=32)),
                             ("multivit", dict(img_size=32, dim_tokens=32, depth=1,
                                               num_heads=4))):
            module = BCModule(build_image_policy(backbone, 4, hidden_dim=32, chunk=5,
                                                 enc_layers=1, dec_layers=2, nhead=4,
                                                 backbone_kw=kw, device="cpu"))
            a_hat = module.predict(build_image_batch(1, 24, 4, chunk=5, with_actions=False))
            assert tuple(a_hat.shape) == (1, 5, 7), a_hat.shape
            for precision in ("32-true", "bf16-mixed"):
                metrics = Trainer(precision=precision, seed=0).train_step(
                    module, build_image_batch(4, 24, 4, chunk=5))
                assert bool(metrics["loss"].isfinite()), metrics
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_image_dp_and_the_converter_run_without_jax(tmp_path):
    """With jax, flax, optax and orbax blocked: a tiny image Diffusion
    Policy (ResNet-18, RGB-D, random crops on) predicts and takes an f32
    and a ``"bf16-mixed"`` step; a reference ``.ckpt`` of it goes through
    the converter's command and restores bit for bit; nothing of the JAX
    package was imported."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import torch
        from pointcloudmatters_tpu_torch import port_reference_ckpt
        from pointcloudmatters_tpu_torch.entry import (build_image_dp_batch,
                                                       build_image_dp_policy)
        from pointcloudmatters_tpu_torch.models.maniskill2_modules import (
            ManiSkill2DiffusionPolicyBCModule)
        from pointcloudmatters_tpu_torch.trainer import Trainer
        from tools.reference_ckpt import reference_state_dict, save_lightning_ckpt

        def policy(seed):
            return build_image_dp_policy(
                "resnet", 4, backbone_kw=dict(resnet_model="resnet18", resize_to=32),
                encoder_kw=dict(resize_shape=(40, 40), crop_shape=(32, 32), random_crop=True),
                down_dims=(8, 16), diffusion_step_embed_dim=8, horizon=8, n_action_steps=4,
                num_inference_steps=3, num_train_timesteps=3, seed=seed, device="cpu")

        module = ManiSkill2DiffusionPolicyBCModule(policy(0))
        action = module.predict(build_image_dp_batch(1, 24, 4, horizon=8, with_actions=False),
                                torch.Generator().manual_seed(0))
        assert tuple(action.shape) == (1, 4, 7), action.shape
        for precision in ("32-true", "bf16-mixed"):
            metrics = Trainer(precision=precision, seed=0).train_step(
                module, build_image_dp_batch(4, 24, 4, horizon=8))
            assert bool(metrics["loss"].isfinite()), metrics
        save_lightning_ckpt({str(tmp_path / "ref.ckpt")!r},
                            reference_state_dict(module.policy))
        port_reference_ckpt.main([{str(tmp_path / "ref.ckpt")!r}, {str(tmp_path / "out")!r}])
        fresh = ManiSkill2DiffusionPolicyBCModule(policy(1))
        Trainer(accelerator="cpu", seed=0).restore_checkpoint({str(tmp_path / "out")!r}, fresh)
        want = module.policy.state_dict()
        assert all(torch.equal(v, want[k]) for k, v in fresh.policy.state_dict().items())
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_cli_trains_without_jax(tmp_path):
    """``pointcloudmatters_tpu_torch.train.main`` composes ``configs/`` and
    fits the flagship composition (tiny widths, on the CPU) with jax, flax,
    optax and orbax blocked, and imports nothing of the JAX package."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from tests.synth import make_synthetic_maniskill2
        from pointcloudmatters_tpu_torch.train import main
        demo = make_synthetic_maniskill2({str(tmp_path / "demo.h5")!r}, n_episodes=2,
                                         episode_len=6, cam_side=16)
        main(["exp_maniskill2_act_policy=base",
              "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
              "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
              "trainer=cpu", "debug=default", "logger=csv", "extras.print_config=false",
              "data.train.dataset_file=" + demo, "data.train.point_num_per_cam=256",
              "data.train.chunk_size=5", "data.train.cache_dir={tmp_path}/cache",
              "data.batch_size_train=2", "data.pad_multiple=64",
              "model.policy.hidden_dim=32", "model.policy.pcd_npoints=16",
              "model.policy.pcd_nsample=4", "model.policy.transformer.num_encoder_layers=1",
              "model.policy.transformer.num_decoder_layers=1",
              "model.policy.transformer.nhead=4", "hydra.run.dir={tmp_path}/run",
              "paths.log_dir={tmp_path}/logs"])
        assert os.path.isfile("{tmp_path}/run/checkpoints/last/checkpoint.pt")
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_rlbench_trains_and_evaluates_without_jax(tmp_path):
    """With jax, flax, optax and orbax blocked: RLBench episodes written by
    ``entry.write_rlbench_episodes``, ``train.main`` on the RLBench ACT
    composition (tiny widths, the CPU, one epoch, profiled), then
    ``test_rlbench_act.main`` on its checkpoint against a fake task with a
    ``CachedTextEncoder`` goal; nothing of the JAX package imported."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np
        from pointcloudmatters_tpu_torch import test_rlbench_act
        from pointcloudmatters_tpu_torch.entry import write_rlbench_episodes
        from pointcloudmatters_tpu_torch.train import main
        from pointcloudmatters_tpu_torch.utils import rlbench_utils as RU
        root = write_rlbench_episodes({str(tmp_path / "data")!r}, n_episodes=2,
                                      episode_len=5)
        argv = ["exp_rlbench_act_policy=base",
                "exp_rlbench_act_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd",
                "rlbench_task=close_jar", "data.train.root=" + root + "/train",
                "data.val.root=" + root + "/val", "trainer.accelerator=cpu",
                "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1",
                "+trainer.profiler=simple", "logger=csv", "extras.print_config=false",
                "data.train.chunk_size=4", "data.batch_size_train=2", "data.batch_size_val=2",
                "data.pad_multiple=64", "data.num_workers=0", "model.policy.hidden_dim=32",
                "model.policy.pcd_npoints=16", "model.policy.pcd_nsample=4",
                "model.policy.transformer.num_encoder_layers=1",
                "model.policy.transformer.num_decoder_layers=1",
                "model.policy.transformer.nhead=4", "hydra.run.dir={tmp_path}/run",
                "paths.log_dir={tmp_path}/logs"]
        main(argv)
        assert os.path.isfile("{tmp_path}/run/torch_trace/trace.json")
        frame = np.load(root + "/train/close_jar/ep0.npy", allow_pickle=True).item()["demo"][0]

        class Task:
            def step(self, action):
                assert action.shape == (9,)
                return frame, 1.0, False

            def shutdown(self):
                pass

        task = Task()
        RU.build_env_and_task = lambda cfg: (task, task)
        RU.reset_task = lambda t, cfg, ep: (t, None, ["close the jar"], frame)
        cache = RU.CachedTextEncoder("{tmp_path}/clip.npz")
        cache.put("close the jar", np.ones(512, np.float32))
        cache.save()
        out = test_rlbench_act.main(argv + [
            "ckpt_path={tmp_path}/run/checkpoints/last", "episodes_num=1", "max_steps=2",
            "result_path={tmp_path}/results", "clip_cache_path={tmp_path}/clip.npz"])
        assert out == {{"success_rate": 1.0}}, out
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_swa_and_the_library_surface_run_without_jax(tmp_path):
    """With jax, flax, optax and orbax blocked: the composer instantiates
    ``configs/callbacks/stochastic_weight_averaging.yaml`` as the port's
    class; ``train.main`` fits the flagship composition with
    ``callbacks=stochastic_weight_averaging`` (tiny widths, the CPU, 2
    epochs) and swaps the average in; the state-only ACT predicts and
    steps; ``ACTPCD(use_mask=True)`` predicts; ``TransformerForDiffusion``,
    the timm-style builder, the schedulers and the library point ops run;
    nothing of the JAX package is imported."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np
        import torch
        from tests.synth import make_synthetic_maniskill2
        from pointcloudmatters_tpu_torch import callbacks, entry
        from pointcloudmatters_tpu_torch.models.bc_module import BCModule
        from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import (
            transformer_for_diffusion as tfd)
        from pointcloudmatters_tpu_torch.ops import pointops
        from pointcloudmatters_tpu_torch.train import main
        from pointcloudmatters_tpu_torch.trainer import Trainer
        from pointcloudmatters_tpu_torch.utils import config as C, optimizer, scheduler
        from pointcloudmatters_tpu_torch.utils.utils import instantiate_callbacks
        cfg = C.compose("configs", "train", ["callbacks=stochastic_weight_averaging"])
        (swa,) = instantiate_callbacks(cfg.callbacks)
        assert type(swa) is callbacks.StochasticWeightAveraging and swa.swa_lrs == 0.05
        demo = make_synthetic_maniskill2({str(tmp_path / "demo.h5")!r}, n_episodes=2,
                                         episode_len=6, cam_side=16)
        main(["exp_maniskill2_act_policy=base",
              "exp_maniskill2_act_policy/maniskill2_pcd_task@maniskill2_pcd_task=PickCube-v0",
              "exp_maniskill2_act_policy/maniskill2_model@maniskill2_model=scratch_pointnet_pcd",
              "trainer=cpu", "debug=default", "trainer.max_epochs=2", "logger=csv",
              "callbacks=stochastic_weight_averaging", "extras.print_config=false",
              "callbacks.stochastic_weight_averaging.swa_epoch_start=0.5",
              "callbacks.stochastic_weight_averaging.annealing_epochs=1",
              "data.train.dataset_file=" + demo, "data.train.point_num_per_cam=256",
              "data.train.chunk_size=5", "data.train.cache_dir={tmp_path}/cache",
              "data.batch_size_train=2", "data.pad_multiple=64",
              "model.policy.hidden_dim=32", "model.policy.pcd_npoints=16",
              "model.policy.pcd_nsample=4", "model.policy.transformer.num_encoder_layers=1",
              "model.policy.transformer.num_decoder_layers=1",
              "model.policy.transformer.nhead=4", "hydra.run.dir={tmp_path}/run",
              "paths.log_dir={tmp_path}/logs"])
        tiny = dict(hidden_dim=32, chunk=5, enc_layers=1, dec_layers=1, nhead=4, device="cpu")
        module = BCModule(entry.build_state_policy(env_state_dim=6, **tiny))
        batch = entry.build_state_batch(2, env_state_dim=6, chunk=5)
        assert module.predict(batch).shape == (2, 5, 7)
        Trainer(accelerator="cpu").train_step(
            module, {{k: torch.as_tensor(v) for k, v in batch.items()}})
        masked = BCModule(entry.build_flagship(npoints=16, nsample=4, use_mask=True,
                                               bg_ratio=0.25, **tiny))
        pcd = entry.build_batch(2, n_points=64, chunk=5, with_actions=False)
        pcd["pcds"]["mask"] = np.arange(64)[None].repeat(2, 0) % 3 == 1
        assert masked.predict(pcd).shape == (2, 5, 7)
        net = tfd.TransformerForDiffusion(input_dim=4, output_dim=4, horizon=6, n_layer=1,
                                          n_head=2, n_emb=8, n_obs_steps=2, cond_dim=3)
        assert net(torch.zeros(2, 6, 4), 3, torch.zeros(2, 2, 3)).shape == (2, 6, 4)
        opt, sched = optimizer.build_optimizer_v2(
            {{"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05, "layer_decay": 0.75}}, net,
            lr_schedule=scheduler.cosine_lr_scheduler(1e-3, 10, warmup_t=2))
        opt.step(); sched.step()
        xyz = torch.rand(40, 3)
        idx, _ = pointops.ball_query(4, 0.3, 0.0, xyz, torch.tensor([25, 40]))
        assert idx.shape == (40, 4)
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert "SWA: swapping in the average of 1 epoch-end" in proc.stdout + proc.stderr


def test_preprocessing_and_unpooled_encoders_run_without_jax(tmp_path):
    """With jax, flax, optax and orbax blocked: ``preprocess_rlbench.main``
    against ``tools/fake_rlbench.py`` (2 + 1 episodes, ``--text-encoder
    hash``) writes episodes that the RLBench ACT dataset of ``configs/``
    reads; a per-key ResNet-18 without ``avg_pool`` sizes the encoder and
    encodes two cameras; nothing of the JAX package is imported."""
    script = textwrap.dedent(f"""
        import os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import numpy as np
        import torch
        from tools import fake_rlbench
        from pointcloudmatters_tpu_torch import entry, preprocess_rlbench
        from pointcloudmatters_tpu_torch.models.components.diffusion_policy.vision import (
            multi_image_obs_encoder as mio)
        from pointcloudmatters_tpu_torch.models.components.img_encoder.resnet import (
            ResNetTorchVision)
        from pointcloudmatters_tpu_torch.train import compose_run
        from pointcloudmatters_tpu_torch.utils import config as C
        raw = fake_rlbench.write_raw({str(tmp_path / "raw")!r}, episodes={{"train": 2, "val": 1}})
        preprocess_rlbench.EPISODES = {{"train": 2, "val": 1}}
        with fake_rlbench.installed(side=16, frames=4):
            preprocess_rlbench.main(["--task_names", "close_jar", "--root", raw,
                                     "--save_root", "{tmp_path}/out", "--text-encoder", "hash"])
        assert sorted(os.listdir("{tmp_path}/out/train/close_jar")) == ["ep0.npy", "ep1.npy"]
        cfg = compose_run(["exp_rlbench_act_policy=base",
                           "exp_rlbench_act_policy/rlbench_model@rlbench_model=scratch_pointnet_pcd",
                           "rlbench_task=close_jar", "data.train.root={tmp_path}/out/train",
                           "data.val.root={tmp_path}/out/val", "data.num_workers=0",
                           "extras.print_config=false"], output_dir="{tmp_path}/run")
        data = C.instantiate(cfg.data)
        data.setup("fit")
        assert len(data.data_train) > 0 and data.data_train[0]
        meta = entry.image_dp_shape_meta(3, ("base_camera", "hand_camera"), side=32)
        enc = mio.MultiImageObsEncoder(
            meta, ResNetTorchVision("resnet18", channels=3, resize_to=64, avg_pool=False))
        assert enc.feature_dim == 2 * 2 * 2 * 512 + 9
        batch = entry.build_image_dp_batch(2, 32, 3, ("base_camera", "hand_camera"),
                                           n_obs_steps=1, horizon=1)
        out = enc({{k: torch.from_numpy(v[:, 0]) for k, v in batch["obs"].items()}})
        assert tuple(out.shape) == (2, enc.feature_dim)
        assert not [m for m in sys.modules if m.split(".")[0] in
                    {BLOCKED + ("pointcloudmatters_tpu",)!r}
                    and sys.modules[m] is not None]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_cuda_sources_are_built_and_stand_alone():
    from pointcloudmatters_tpu_torch import _build

    sources = sorted(p.stem for p in pathlib.Path(_build.CSRC).glob("*.cu"))
    assert sources == sorted(_build.KERNELS)
    for path in pathlib.Path(_build.CSRC).iterdir():
        text = path.read_text()
        assert "torch/" not in text and "jax" not in text.lower(), path.name


# ROADMAP.md §1 "Do not port": JAX-only plumbing, TPU toolchain pieces and
# names nothing composes, by the JAX package's file; the Pallas kernels'
# files are ported under the port's names (ops/fps.py, ops/knn*.py)
DO_NOT_PORT = {
    "models/components/act/transformer.py": {"EfficientMHA"},
    "models/components/diffusion_policy/diffusion/conditional_unet1d.py": {"port_torch_state"},
    "models/components/nn_utils.py": {"Dtype"},
    "ops/flash_attention.py": {"BlockSizes", "MIN_BLOCK_SIZE", "NUM_LANES", "NUM_SUBLANES",
                               "TRANS_B_DIM_NUMBERS", "below_or_on_diag", "mha_reference",
                               "mha_reference_bwd", "mha_reference_no_custom_vjp"},
    "ops/fused_builder.py": {"grouped_stats_core"},
    "trainer.py": {"TrainState", "Trainer.mesh", "Trainer.shard_batch"},
    "models/bc_module.py": {"BCModule.apply_train", "BCModule.initial_state"},
    "utils/optimizer.py": {"ScalarOrSchedule", "scale_by_adam_b1_schedule"},
    "utils/profiling.py": {"JaxProfiler"},
    "ops/pallas_fps.py": "ops/fps.py",
    "ops/pallas_knn.py": "ops/knn_baseline.py",
    "ops/pallas_knn2.py": "ops/knn_chunkskip.py",
    "ops/pallas_knn3.py": "ops/knn.py",
    "utils/pytree_utils.py": "*",
    "utils/registry.py": "*",
    "utils/torch_layouts.py": "*",
}


def _public_names(path: pathlib.Path) -> tuple[set, dict]:
    """Top-level public names of a module, and each class's public
    methods (flax's ``setup`` is the modules' constructor, not API)."""
    names, methods = set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = {
                    m.name for m in node.body
                    if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")
                    and m.name != "setup"}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")}
        elif (isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
              and not node.target.id.startswith("_")):
            names.add(node.target.id)
    return names - {"log"}, methods  # module loggers are not API


def test_every_public_jax_name_has_a_counterpart():
    """Each public name of each module of the JAX package (functions,
    classes, constants, classes' public methods) is in the port's module of
    the same path, or on ROADMAP.md's "Do not port" list."""
    import importlib

    jax_root, port_root = REPO_ROOT / "pointcloudmatters_tpu", REPO_ROOT / \
        "pointcloudmatters_tpu_torch"
    missing = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        skip = DO_NOT_PORT.get(rel, set())
        if skip == "*":
            continue
        port = port_root / (skip if isinstance(skip, str) else rel)
        if isinstance(skip, str):
            assert port.is_file(), rel
            continue
        if not port.is_file():
            missing.append(rel)
            continue
        names, methods = _public_names(path)
        port_names, _ = _public_names(port)
        missing += [f"{rel}:{n}" for n in sorted(names - port_names - skip)]
        module = importlib.import_module(
            "pointcloudmatters_tpu_torch." + rel[:-3].replace("/", ".").replace(
                ".__init__", ""))
        for cls, ms in methods.items():
            if cls in skip or not hasattr(module, cls):
                continue
            missing += [f"{rel}:{cls}.{m}" for m in sorted(ms)
                        if f"{cls}.{m}" not in skip and not hasattr(getattr(module, cls), m)]
    assert not missing, missing
