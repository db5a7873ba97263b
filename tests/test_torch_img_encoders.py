"""The port's image encoders (``pointcloudmatters_tpu_torch/models/components/
img_encoder/``, ``utils/image.py``, the 2-D position embeddings) against
the JAX package's, on the CPU, at tiny widths: ResNet-18 resizing 24-pixel
images to 32, a ViT of ``img_size`` 32, patch 8, depth 2, width 32 and 4
heads (over 24-pixel images: resized to 36 and cropped), a MultiViT of
width 32, depth 2 and 4 heads (``img_size`` 32).

Inputs come from numpy seeds; JAX's variables are randomised (biases, norm
scales of either sign, running statistics), carried over by
``flax_to_torch``, and each backbone case compiles JAX once (the eval
output and the gradients of a fixed cotangent through it, the train-mode
output, the batch statistics after it and its gradients, in one function).

Limits: the resize within 1e-6 of ``jax.image.resize``; the sincos tables
equal, the 2-D embeddings within 1e-6; a backbone's eval output within
1e-5 · max(1, max|JAX|); every gradient 1e-4 · max(1, max|JAX|) of its
tensor; the train-mode output 1e-4 of its largest entry and the running
statistics after it 1e-5 of theirs; the loaders bit-equal to JAX's on fake
state dicts with the real key names.

ResNet's train-mode gradients are held against JAX's for the batch in
its order and reversed, on images from seeds 0-3. JAX's own answer depends
on that order at 12 of 32 such batches, by up to 21% of a tensor's
largest entry (``tests/batch_order_gradients.py``). Both packages sum a
batch norm's statistics in f32, even for f64 activations
(``nn_utils.py:103-105`` of the JAX package), and the order of the sum
moves the normalised values by about 1e-6. A ReLU input that lies that
close to zero then routes its gradient one way or the other, and a batch
norm in training spreads that to every element of its channel. The port
matched one of JAX's two orders within 6e-5 at each of the 32, and with
the sums made f64 in both packages every gradient agrees within 2e-13
(``test_resnet_train_gradients_match_jax_with_f64_statistics`` holds one
such batch at 1e-8). So where JAX's two orders agree, the port must match
both; where they do not, it must match one; and every channel count has a
seed of the first kind. The ResNet cases take 8 images: its last stage is
1 x 1 at 32 pixels, and a batch norm over the 2 values of a batch of 2
magnifies rounding to 5% of the output.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.models.components import nn_utils as jnn_utils
from pointcloudmatters_tpu.models.components.act import positional_encoding as jpe
from pointcloudmatters_tpu.models.components.img_encoder import multivit as jmultivit
from pointcloudmatters_tpu.models.components.img_encoder import resnet as jresnet
from pointcloudmatters_tpu.models.components.img_encoder import vit as jvit
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn_utils
from pointcloudmatters_tpu_torch.models.components import pretrained as tpretrained
from pointcloudmatters_tpu_torch.models.components.act import positional_encoding as tpe
from pointcloudmatters_tpu_torch.models.components.img_encoder import multivit as tmultivit
from pointcloudmatters_tpu_torch.models.components.img_encoder import resnet as tresnet
from pointcloudmatters_tpu_torch.models.components.img_encoder import vit as tvit
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from pointcloudmatters_tpu_torch.utils.image import resize
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401

TINY_VIT = "vit_tiny_test"
TINY_ARCH = dict(embed_dim=32, depth=2, num_heads=4, patch_size=8)
MULTIVIT = dict(img_size=32, dim_tokens=32, depth=2, num_heads=4)
IMG = 24  # pixels a side of the test images
CASES = [(kind, c) for kind in ("resnet", "vit") for c in (1, 3, 4, 6)] + [("multivit", 4)]
RESNET_SEEDS = (0, 1, 2, 3)  # image seeds of the ResNet train-mode gradients


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread here, as the test processes run several at once
    beside JAX's thread pool (tiny convolutions ran many times slower on
    all the cores, ``tests/test_torch_diffusion_policy.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_arch():
    """A tiny ViT architecture in both packages' tables (the ViT wrapper
    takes its widths, and its patch size, from the table)."""
    jvit._ARCHS[TINY_VIT] = tvit.ARCHS[TINY_VIT] = TINY_ARCH
    yield
    del jvit._ARCHS[TINY_VIT], tvit.ARCHS[TINY_VIT]


def backbones(kind: str, channels: int, **kw):
    """(JAX module, port module) of a tiny backbone."""
    if kind == "resnet":
        args = dict(resnet_model="resnet18", channels=channels, resize_to=32, **kw)
        return jresnet.ResNetTorchVision(**args), tresnet.ResNetTorchVision(**args)
    if kind == "vit":
        args = dict(model_name=TINY_VIT, channels=channels, img_size=32, **kw)
        return jvit.ViT(**args), tvit.ViT(**args)
    return jmultivit.MultiViTModel(**MULTIVIT), tmultivit.MultiViTModel(**MULTIVIT)


def _images(channels: int, batch: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(batch, IMG, IMG, channels).astype(np.float32)


def _case_images(case) -> np.ndarray:
    return _images(case["channels"], 8 if case["kind"] == "resnet" else 2)


def init_variables(jmod, x, seed: int = 3) -> dict:
    """JAX variables of ``jmod`` without compiling its init: the shapes from
    ``jax.eval_shape``, kernels and the modules' own tables normal with std
    1/sqrt(fan-in) (all but the last axis), learned position tables uniform
    in [0, 1), then ``_randomize`` (biases, norm scales, statistics)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda b: jmod.init(jax.random.PRNGKey(0), b), x)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("row_embed", "col_embed"):
            return rng.rand(*shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) or 1
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(np.asarray, _randomize(jax.tree_util.tree_map_with_path(leaf, shapes),
                                               seed))


def _close(got, ref, limit, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=limit, err_msg=what)


# ---------------------------------------------------------------------------
# the resize and the position tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(24, 32), (24, 36), (128, 224), (128, 256), (40, 24),
                                   (36, 7)], ids=str)
def test_resize_matches_jax_image_resize(method, sizes):
    h, H = sizes
    x = np.random.RandomState(h + H).rand(2, h, h + 3, 4).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, H, H + 1, 4), method=method))
    got = resize(torch.from_numpy(x), (H, H + 1), method)
    assert got.shape == ref.shape
    _close(got, ref, 1e-6, f"{method} {sizes}")


def test_torch_bicubic_is_not_jax_bicubic():
    """Why the port builds its own matrices: ``F.interpolate``'s bicubic
    (a = -0.75) is far from JAX's (a = -0.5) on a 128 -> 256 upsample."""
    x = np.random.RandomState(0).rand(1, 128, 128, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (1, 256, 256, 3), method="bicubic"))
    other = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                            size=(256, 256), mode="bicubic")
    assert np.abs(other.permute(0, 2, 3, 1).numpy() - ref).max() > 0.05


@pytest.mark.parametrize("dim,grid,cls", [(32, 4, True), (768, 14, True), (32, 2, False)])
def test_sincos_tables_equal_jax(dim, grid, cls):
    np.testing.assert_array_equal(tvit.get_2d_sincos_pos_embed(dim, grid, cls),
                                  jvit.get_2d_sincos_pos_embed(dim, grid, cls))


@pytest.mark.parametrize("hw,normalize", [((7, 7), True), ((1, 1), True), ((3, 5), False)],
                         ids=str)
def test_sine_embedding_matches_jax(hw, normalize):
    fmap = np.zeros((2, *hw, 8), np.float32)
    ref = jpe.PositionEmbeddingSine(num_pos_feats=16, normalize=normalize)(jnp.asarray(fmap))
    got = tpe.PositionEmbeddingSine(num_pos_feats=16, normalize=normalize)(torch.from_numpy(fmap))
    assert tuple(got.shape) == (1, hw[0] * hw[1], 32) and got.dtype == torch.float32
    _close(got, np.asarray(ref), 1e-6)


def test_sine_embedding_is_interleaved_and_refuses_a_scale_alone():
    pos = tpe.PositionEmbeddingSine(num_pos_feats=4)(torch.zeros(1, 1, 1, 1))[0, 0]
    torch.testing.assert_close(pos[:4][1::2], torch.cos(torch.tensor([1.0, 0.01])))  # y's cosines
    with pytest.raises(ValueError, match="normalize"):
        tpe.PositionEmbeddingSine(scale=1.0)


def test_learned_embedding_matches_jax():
    fmap = jnp.zeros((2, 3, 5, 8))
    jmod = jpe.PositionEmbeddingLearned(num_pos_feats=6)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), fmap))
    tmod = tpe.PositionEmbeddingLearned(num_pos_feats=6)
    tmod.load_state_dict(flax_to_torch(variables, tmod))
    _close(tmod(torch.zeros(2, 3, 5, 8)), np.asarray(jmod.apply(variables, fmap)), 1e-6)
    tentry.init_parameters(tmod, torch.Generator().manual_seed(0))
    assert 0 <= tmod.row_embed.min() and tmod.row_embed.max() < 1  # flax's uniform(1.0)


# ---------------------------------------------------------------------------
# the backbones against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}ch")
def backbone_case(request):
    """JAX's randomised variables of a case, a cotangent, and in one
    compile: the eval output and the gradients of sum(out * cot) through
    it, the train-mode output, the batch statistics after it and its
    gradients. For ResNet, also the train-mode gradients of the images of
    each of ``RESNET_SEEDS`` in their order and reversed (module doc)."""
    kind, channels = request.param
    jmod, _ = backbones(kind, channels)
    x = jnp.asarray(_case_images(dict(kind=kind, channels=channels)))
    variables = init_variables(jmod, x)
    stats = variables.get("batch_stats", {})
    shape = jax.eval_shape(lambda v, b: jmod.apply(v, b), variables, x).shape
    cot = np.random.RandomState(1).randn(*shape).astype(np.float32)

    def ref(params, images, cot):
        def loss(p, train):
            out, mut = jmod.apply({"params": p, "batch_stats": stats}, images, train=train,
                                  mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut.get("batch_stats", {}))

        results = {}
        for train in (False, True):
            (_, (out, new_stats)), grads = jax.value_and_grad(
                lambda p, t=train: loss(p, t), has_aux=True)(params)
            results[train] = (out, new_stats, grads)
        return results

    ref = jax.jit(ref)
    out = jax.tree.map(np.asarray, ref(variables["params"], x, cot))
    orders = {}
    if kind == "resnet":
        for seed in RESNET_SEEDS:
            images = _images(channels, 8, seed)
            orders[seed] = [jax.tree.map(np.asarray, ref(variables["params"], b, c)[True][2])
                            for b, c in ((images, cot), (images[::-1], cot[::-1]))]
    return dict(kind=kind, channels=channels, variables=variables, cot=cot, eval=out[False],
                train=out[True], orders=orders)


def _port(case):
    _, tmod = backbones(case["kind"], case["channels"])
    tmod.load_state_dict(flax_to_torch(case["variables"], tmod), strict=True)
    return tmod.eval()


def _check_grads(tmod, grads, stats):
    ref_grads = flax_to_torch({"params": grads, "batch_stats": stats}, tmod)
    for name, p in tmod.named_parameters():
        g = ref_grads[name].numpy()
        _close(p.grad, g, 1e-4 * max(1.0, np.abs(g).max()), f"grad {name}")


def _port_grads(grads, stats, tmod) -> dict:
    """JAX's gradient tree as {parameter name: array} of ``tmod``."""
    ref = flax_to_torch({"params": grads, "batch_stats": stats}, tmod)
    return {n: ref[n].numpy() for n, _ in tmod.named_parameters()}


def _grad_excess(got: dict, ref: dict) -> tuple:
    """(largest |got - ref| / (1e-4 * max(1, max|ref|)) over the
    parameters, its name): at most 1 where every gradient is within its
    limit."""
    return max((np.abs(got[n] - ref[n]).max() / (1e-4 * max(1.0, np.abs(ref[n]).max())), n)
               for n in ref)


def test_backbone_eval_matches_jax(backbone_case):
    """Eval mode: the output and every parameter's gradient."""
    tmod = _port(backbone_case)
    got = tmod(torch.from_numpy(_case_images(backbone_case)), train=False)
    ref = backbone_case["eval"][0]
    assert tuple(got.shape) == ref.shape
    _close(got, ref, 1e-5 * max(1.0, np.abs(ref).max()))
    (got * torch.from_numpy(backbone_case["cot"])).sum().backward()
    _check_grads(tmod, backbone_case["eval"][2], backbone_case["variables"].get("batch_stats", {}))


def test_backbone_train_matches_jax(backbone_case):
    """Train mode: the output and the running statistics after it
    (unbiased variance, torch momentum), and every parameter's gradient.
    ResNet's gradients on the images of each of ``RESNET_SEEDS``: within
    the limit of JAX's for the batch in both orders where JAX's two agree
    within it, of one of them where they do not (module doc)."""
    tmod = _port(backbone_case)
    got = tmod(torch.from_numpy(_case_images(backbone_case)), train=True)
    out, stats, grads = backbone_case["train"]
    _close(got, out, 1e-4 * max(1.0, np.abs(out).max()), "train output")
    variables = backbone_case["variables"]
    after = flax_to_torch({"params": variables["params"], "batch_stats": stats}, tmod)
    n_stats = 0
    for name, buf in tmod.state_dict().items():
        if name.endswith((".mean", ".var")):
            ref = after[name].numpy()
            _close(buf, ref, 1e-5 * max(1.0, np.abs(ref).max()), name)
            n_stats += 1
    assert n_stats == (2 * 20 if backbone_case["kind"] == "resnet" else 0)
    if backbone_case["kind"] != "resnet":
        (got * torch.from_numpy(backbone_case["cot"])).sum().backward()
        _check_grads(tmod, grads, {})
        return
    cot = torch.from_numpy(backbone_case["cot"])
    agreed = 0
    for seed, orders in backbone_case["orders"].items():
        tmod.zero_grad()
        (tmod(torch.from_numpy(_images(backbone_case["channels"], 8, seed)), train=True)
         * cot).sum().backward()
        port = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
        given, reversed_ = (_port_grads(g, variables["batch_stats"], tmod) for g in orders)
        gaps = [_grad_excess(port, g) for g in (given, reversed_)]
        jax_self = _grad_excess(reversed_, given)
        if jax_self[0] <= 1:
            agreed += 1
            assert max(gaps)[0] <= 1, (seed, gaps)
        else:
            assert min(gaps)[0] <= 1, (seed, gaps, jax_self)
    assert agreed > 0


class SumInItsType:
    """``jax.numpy`` for the JAX package's batch norm, but ``sum`` in the
    input's type (its ``dtype=float32`` ignored)."""

    def __init__(self, numpy):
        self._numpy = numpy

    def __getattr__(self, name):
        return getattr(self._numpy, name)

    def sum(self, x, axis=None, dtype=None):
        return self._numpy.sum(x, axis=axis)


def _sum_in_its_type(self, x, mask=None, use_running_average=True):
    """The port's ``MaskedBatchNorm.forward`` (no mask), summing in x's type."""
    if use_running_average:
        mean, var = self.mean, self.var
    else:
        dims = tuple(range(x.ndim - 1))
        count = torch.full((), float(np.prod(x.shape[:-1])), dtype=x.dtype)
        mean, var = self.statistics(x.sum(dim=dims), (x * x).sum(dim=dims), count)
    eff_scale, eff_bias = self.affine(mean, var)
    return x * eff_scale.to(x.dtype) + eff_bias.to(x.dtype)


def f64_statistics(setattr_) -> None:
    """Both packages' batch norms summing their statistics in the
    activations' type (``setattr_``: ``monkeypatch.setattr`` or ``setattr``)."""
    setattr_(jnn_utils, "jnp", SumInItsType(jnn_utils.jnp))
    setattr_(tnn_utils.MaskedBatchNorm, "forward", _sum_in_its_type)


def test_resnet_train_gradients_match_jax_with_f64_statistics(monkeypatch):
    """The batch whose gradients JAX's two orders disagree on by 5.5% in
    f32 (3 channels, images of seed 0), in f64 on both sides with the batch
    norms summing in f64 (both packages sum in f32 as they ship): JAX's two
    orders agree, and the port's train-mode gradients match them, within
    1e-8 * max(1, max|g|) a tensor."""
    f64_statistics(monkeypatch.setattr)
    jmod, tmod = backbones("resnet", 3)
    x = _images(3, 8).astype(np.float64)
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 init_variables(jmod, jnp.asarray(x)))
        stats = variables["batch_stats"]
        shape = jax.eval_shape(lambda v, b: jmod.apply(v, b), variables, jnp.asarray(x)).shape
        cot = np.random.RandomState(1).randn(*shape)

        @jax.jit
        def grads(params, images, c):
            def loss(p):
                out, _ = jmod.apply({"params": p, "batch_stats": stats}, images, train=True,
                                    mutable=["batch_stats"])
                return jnp.sum(out * c)
            return jax.grad(loss)(params)

        orders = [jax.tree.map(np.asarray, grads(variables["params"], jnp.asarray(b),
                                                 jnp.asarray(c)))
                  for b, c in ((x, cot), (x[::-1], cot[::-1]))]
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    tmod.double()
    (tmod(torch.from_numpy(x), train=True) * torch.from_numpy(cot)).sum().backward()
    port = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    given, reversed_ = (_port_grads(g, stats, tmod) for g in orders)
    assert _grad_excess(reversed_, given)[0] <= 1e-4  # 1e-8 of the largest entry
    for ref in (given, reversed_):
        gap = _grad_excess(port, ref)
        assert gap[0] <= 1e-4, gap


@pytest.mark.parametrize("block,c_in,features,stride,down", [
    ("basic", 64, 64, 1, False), ("basic", 64, 128, 2, True),
    ("bottleneck", 64, 64, 1, True), ("bottleneck", 256, 128, 2, True)], ids=str)
def test_resnet_blocks_train_like_jax(block, c_in, features, stride, down):
    """Each block type in training on ReLU'd inputs (4 x 8 x 8): the output,
    the gradients of its input and parameters, the running statistics."""
    jcls, tcls = ((jresnet.BasicBlock, tresnet.BasicBlock) if block == "basic"
                  else (jresnet.Bottleneck, tresnet.Bottleneck))
    jmod = jcls(features, stride=stride, downsample=down)
    tmod = tcls(c_in, features, stride, down)
    rng = np.random.RandomState(5)
    x = np.maximum(rng.randn(4, 8, 8, c_in), 0).astype(np.float32)
    variables = init_variables(jmod, jnp.asarray(x))
    out_shape = jax.eval_shape(lambda v, b: jmod.apply(v, b), variables, jnp.asarray(x)).shape
    cot = rng.randn(*out_shape).astype(np.float32)

    def loss(p, xx):
        out, mut = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]}, xx,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (out, stats)), (grads, gx) = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x)))
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = tmod(xt, train=True)
    _close(got, out, 1e-5 * max(1.0, np.abs(out).max()), "output")
    (got * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, gx, 1e-4 * max(1.0, np.abs(gx).max()), "input grad")
    _check_grads(tmod, grads, variables["batch_stats"])
    after = flax_to_torch({"params": variables["params"], "batch_stats": stats}, tmod)
    for name, buf in tmod.state_dict().items():
        if name.endswith((".mean", ".var")):
            _close(buf, after[name].numpy(), 1e-5 * max(1.0, after[name].abs().max().item()), name)


@pytest.mark.parametrize("mode", ["global_pool", "reshape_embedding"])
def test_vit_feature_modes_match_jax(mode):
    jmod, tmod = backbones("vit", 3, feature_mode=mode)
    x = _images(3)
    variables = init_variables(jmod, jnp.asarray(x), 4)
    ref = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == ((2, 32) if mode == "global_pool" else (2, 4, 4, 32))
    _close(got, ref, 1e-5 * max(1.0, np.abs(ref).max()))


def test_mae_masking_keeps_a_quarter_in_training_only():
    """MAE's masking (draws from the generator passed in): 4 of 16 patch
    tokens kept in training, the same draw from the same seed; none in eval."""
    mae = tvit.MAEViT(model_name=TINY_VIT, img_size=32)
    x = torch.from_numpy(_images(3))
    tokens = []
    mae.model.blocks_0.register_forward_hook(lambda m, a, out: tokens.append(out))
    mae(x, train=False)
    draws = [mae(x, train=True, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert [t.shape[1] for t in tokens] == [17, 5, 5] and torch.equal(*draws)
    with pytest.raises(ValueError, match="generator"):
        mae(x, train=True)


def test_mae_masking_matches_jax(monkeypatch):
    """MAE's training forward against JAX's on the same noise: JAX's draw
    from its ``"mask"`` stream recorded and handed to the port's
    ``mask_noise`` (which is given the generator); the output and every
    parameter's gradient (1e-5 and 1e-4 of the largest entry)."""
    jmod, tmod = jvit.MAEViT(model_name=TINY_VIT, img_size=32), tvit.MAEViT(
        model_name=TINY_VIT, img_size=32)
    x = _images(3)
    variables = init_variables(jmod, jnp.asarray(x), 5)
    draw = jvit.VisionTransformer.random_masking

    def recorded(self, tokens, ratio, rng):
        self.sow("intermediates", "noise", jax.random.uniform(rng, tokens.shape[:2]))
        return draw(self, tokens, ratio, rng)

    monkeypatch.setattr(jvit.VisionTransformer, "random_masking", recorded)
    cot = np.random.RandomState(2).randn(2, 32).astype(np.float32)

    def loss(p):
        out, mut = jmod.apply({"params": p}, jnp.asarray(x), train=True,
                              rngs={"mask": jax.random.PRNGKey(3)}, mutable=["intermediates"])
        return jnp.sum(out * cot), (out, mut["intermediates"])

    (_, (out, sown)), grads = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"]))
    noise = jax.tree.leaves(sown)
    assert len(noise) == 1

    def port_noise(shape, generator, device):
        assert isinstance(generator, torch.Generator) and shape == noise[0].shape
        return torch.from_numpy(noise[0].copy())

    monkeypatch.setattr(tvit, "mask_noise", port_noise)
    tmod.load_state_dict(flax_to_torch(variables, tmod), strict=True)
    got = tmod(torch.from_numpy(x), train=True, generator=torch.Generator())
    _close(got, out, 1e-5 * max(1.0, np.abs(out).max()), "train output")
    (got * torch.from_numpy(cot)).sum().backward()
    _check_grads(tmod, grads, {})


def test_truncated_depth_standardize_matches_jax():
    depth = np.random.RandomState(2).rand(3, 20, 20, 1).astype(np.float32) * 2
    ref = np.asarray(jmultivit.truncated_depth_standardize(jnp.asarray(depth)))
    _close(tmultivit.truncated_depth_standardize(torch.from_numpy(depth)), ref,
           1e-5 * np.abs(ref).max())


def test_resnet50_widths_and_init():
    """ResNet-50 at the configs' width has torchvision's 23,508,032
    trainable parameters and 53,120 running statistics, as the JAX module
    (``tests/test_img_encoder.py``); ViT-B/16's drawn ``pos_embed`` is the
    sincos table and its ``cls_token`` a normal cut at 0.04."""
    with torch.device("meta"):
        net = tresnet.ResNetTorchVision()
    assert sum(p.numel() for p in net.parameters()) == 23_508_032
    assert sum(b.numel() for b in net.buffers() if b.ndim and b.shape[0] > 6) == 53_120
    assert net.num_channels == 2048
    vit = tvit.ViT(model_name=TINY_VIT, img_size=32)
    tentry.init_parameters(vit, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(vit.model.pos_embed[0].detach().numpy(),
                                  jvit.get_2d_sincos_pos_embed(32, 4, cls_token=True))
    assert 0 < vit.model.cls_token.abs().max() <= 0.04


# ---------------------------------------------------------------------------
# the loaders, on fake state dicts with the real key names
# ---------------------------------------------------------------------------

def _randn(shape, gen):
    return torch.randn(shape, generator=gen)


def fake_torchvision_resnet(net, prefix: str = "", gen=None) -> dict:
    """A torchvision-named state dict for ``net``'s topology (3-channel
    stem, ``fc``, the batch counters) under ``prefix``."""
    gen = gen or torch.Generator().manual_seed(0)
    sd = {}
    for name, t in net.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        mod = mod.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                      "downsample.1")
        if mod.startswith("layer"):
            stage, rest = mod[len("layer"):].split("_", 1)
            mod = f"layer{stage}.{rest}"
        leaf = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        shape = (t.shape[0], 3) + tuple(t.shape[2:]) if name == "conv1.weight" else t.shape
        value = _randn(shape, gen)
        sd[f"{prefix}{mod}.{leaf}"] = value.abs() + 0.5 if leaf == "running_var" else value
        if leaf == "running_var":
            sd[f"{prefix}{mod}.num_batches_tracked"] = torch.tensor(7)
    sd[f"{prefix}fc.weight"] = _randn((1000, net.num_channels), gen)
    sd[f"{prefix}fc.bias"] = _randn((1000,), gen)
    return sd


def fake_timm_blocks(sd: dict, prefix: str, depth: int, D: int, gen) -> None:
    for i in range(depth):
        p = f"{prefix}.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = _randn(D, gen), _randn(D, gen)
        sd[f"{p}.attn.qkv.weight"], sd[f"{p}.attn.qkv.bias"] = (_randn((3 * D, D), gen),
                                                                _randn(3 * D, gen))
        sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = _randn((D, D), gen), _randn(D, gen)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = (_randn((4 * D, D), gen),
                                                              _randn(4 * D, gen))
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = (_randn((D, 4 * D), gen),
                                                              _randn(D, gen))


def fake_vit(D=32, depth=2, patch=8, grid=4, gen=None) -> dict:
    """A timm / VC-1-named ViT state dict (3-channel patches), with MAE's
    decoder and ``mask_token`` beside it, under ``module.``."""
    gen = gen or torch.Generator().manual_seed(1)
    sd = {"patch_embed.proj.weight": _randn((D, 3, patch, patch), gen),
          "patch_embed.proj.bias": _randn(D, gen),
          "pos_embed": _randn((1, grid * grid + 1, D), gen), "cls_token": _randn((1, 1, D), gen),
          "norm.weight": _randn(D, gen), "norm.bias": _randn(D, gen),
          "mask_token": _randn((1, 1, D), gen), "decoder_embed.weight": _randn((8, D), gen)}
    fake_timm_blocks(sd, "blocks", depth, D, gen)
    return {f"module.{k}": v for k, v in sd.items()}


def fake_multimae(D=32, depth=2, gen=None) -> dict:
    """An EPFL MultiMAE-named state dict, output adapters and semseg beside."""
    gen = gen or torch.Generator().manual_seed(2)
    sd = {"global_tokens": _randn((1, 1, D), gen),
          "input_adapters.rgb.proj.weight": _randn((D, 3, 16, 16), gen),
          "input_adapters.rgb.proj.bias": _randn(D, gen),
          "input_adapters.depth.proj.weight": _randn((D, 1, 16, 16), gen),
          "input_adapters.depth.proj.bias": _randn(D, gen),
          "input_adapters.semseg.proj.weight": _randn((D, 64, 16, 16), gen),
          "output_adapters.rgb.weight": _randn((D, D), gen)}
    fake_timm_blocks(sd, "encoder", depth, D, gen)
    return sd


_VARIABLES: dict = {}


def _jax_variables(jmod, channels):
    """``init_variables`` of a loader test's module, traced once a kind and
    channel count (the loaders fill every entry, whatever its value)."""
    key = (type(jmod).__name__, channels)
    if key not in _VARIABLES:
        _VARIABLES[key] = init_variables(jmod, jnp.zeros((1, 32, 32, channels)))
    return _VARIABLES[key]


@pytest.mark.parametrize("channels,prefix", [(1, ""), (3, ""), (4, "module.convnet."),
                                             (6, "resnet.")], ids=str)
def test_resnet_loader_equals_jax(channels, prefix):
    """A torchvision / R3M state dict: the port's load bit-equal to JAX's,
    the stem inflated (zero at one channel, the quirk)."""
    jmod, tmod = backbones("resnet", channels)
    sd = fake_torchvision_resnet(tmod, prefix)
    variables = _jax_variables(jmod, channels)
    params, stats = jresnet.load_torch_state_dict(variables["params"], variables["batch_stats"],
                                                  {k: v.numpy() for k, v in sd.items()},
                                                  channels=channels)
    ref = flax_to_torch({"params": params, "batch_stats": stats}, tmod)
    tresnet.load_torch_state_dict(tmod, sd)
    got = tmod.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ref.items())
    assert (got["conv1.weight"].abs().sum() == 0) == (channels == 1)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_vit_loader_equals_jax(channels):
    jmod, tmod = backbones("vit", channels)
    sd = fake_vit()
    params = jvit.load_torch_vit_state_dict(_jax_variables(jmod, channels)["params"],
                                            {k: v.numpy() for k, v in sd.items()},
                                            channels=channels)
    ref = flax_to_torch({"params": params}, tmod)
    tvit.load_torch_vit_state_dict(tmod, sd)
    got = tmod.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ref.items())
    assert torch.equal(got["model.blocks_1.attn.value.weight"],
                       sd["module.blocks.1.attn.qkv.weight"][64:])


def test_multimae_loader_equals_jax():
    jmod, tmod = backbones("multivit", 4)
    sd = fake_multimae()
    params = jmultivit.load_torch_multimae_state_dict(_jax_variables(jmod, 4)["params"],
                                                      {k: v.numpy() for k, v in sd.items()})
    ref = flax_to_torch({"params": params}, tmod)
    tmultivit.load_torch_multimae_state_dict(tmod, sd)
    got = tmod.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ref.items())


def test_pretrained_paths_load_the_families(tmp_path):
    """``load_pretrained_into`` reads an R3M file (``{"r3m": ...}``) into
    an R3MResNet and a VC-1 file (``{"model": ...}``) into a VC1ViT,
    as their loaders do."""
    r3m_file, vc1_file = tmp_path / "r3m_50.pt", tmp_path / "vc1.pth"
    r3m = tresnet.R3MResNet(resnet_model="resnet18", resize_to=32,
                            pretrained_path=str(r3m_file))
    sd = fake_torchvision_resnet(r3m, "module.convnet.")
    torch.save({"r3m": sd}, r3m_file)
    vc1 = tvit.VC1ViT(model_name=TINY_VIT, img_size=32, pretrained_path=str(vc1_file))
    torch.save({"model": fake_vit()}, vc1_file)
    tpretrained.load_pretrained_into(torch.nn.ModuleList([r3m, vc1]))
    want = tresnet.resnet_state_dict(r3m, sd)
    assert all(torch.equal(r3m.state_dict()[k], v) for k, v in want.items())
    want = tvit.vit_state_dict(vc1, fake_vit())
    assert all(torch.equal(vc1.state_dict()[k], v) for k, v in want.items())


def test_multivit_ckpt_path_is_not_read(tmp_path, caplog):
    """As in JAX, ``ckpt_path`` is not a pretrained path: a warning, random
    weights kept."""
    with caplog.at_level(logging.WARNING):
        net = tmultivit.MultiViTModel(ckpt_path=str(tmp_path / "multimae.pth"), **{
            k: v for k, v in MULTIVIT.items()})
    assert "ckpt_path" in caplog.text and "not read" in caplog.text
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tpretrained.load_pretrained_into(net)
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
