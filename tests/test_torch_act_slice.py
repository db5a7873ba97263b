"""Parity of the port's ACT + PointNet inference slice with the JAX modules,
in eval, on the CPU.

JAX modules are built at tiny width, their variables randomised (biases,
norm scales of both signs, running statistics) so that every parameter
matters, converted with ``flax_to_torch`` and loaded into the port. Inputs
come from numpy seeds. Tolerances: atol 1e-5 for single modules (f32, only
summation order differs), atol/rtol 1e-4 for the whole policy (a dozen f32
layers deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from pointcloudmatters_tpu.data.collate import morton_order as jax_morton_order
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components import nn_utils as jnn
from pointcloudmatters_tpu.models.components.act import transformer as jtr
from pointcloudmatters_tpu.models.components.act.positional_encoding import (
    coord_embedding_sine as jax_coord_embedding_sine,
)
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.models.components.act import transformer as ttr
from pointcloudmatters_tpu_torch.models.components.act.positional_encoding import (
    coord_embedding_sine,
)
from pointcloudmatters_tpu_torch.models.components.pcd_encoder.pointnet import (
    PointNet,
)
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch

ATOL = 1e-5
FLAGSHIP_PARAMS = 24_124_456


@pytest.fixture(autouse=True)
def threefry_prng():
    """The JAX side draws from JAX's default generator, threefry, whatever
    ran before in the process: a JAX ``Trainer`` built with its default
    ``prng_impl="rbg"`` (``tests/test_rlbench.py`` builds one) switches the
    process-wide default, which would initialise other JAX weights than the
    ones the port tests' limits were measured on. Test files that import it
    get it too."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def test_jax_side_draws_threefry_whatever_ran_before():
    """Under ``threefry_prng`` a key is threefry's even after something in
    the process made ``rbg`` the default (a 4-word key)."""
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        assert jax.random.PRNGKey(0).shape == (2,)
    finally:
        jax.config.update("jax_default_prng_impl", before)


def _randomize(variables, seed):
    """Random biases, norm scales (either sign), means and positive
    variances; kernels and embeddings keep their initialisation."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return (rng.uniform(0.5, 1.5, shape)
                    * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*shape) * 0.2).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _load(module, variables):
    module.load_state_dict(flax_to_torch(variables, module), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_pointnet():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 50, 6).astype(np.float32)
    valid = np.arange(50)[None] < np.array([[50], [31]])
    jm = JPointNet(in_channels=6)
    inp = {"feat": jnp.asarray(feat), "valid": jnp.asarray(valid)}
    variables = _randomize(jm.init(jax.random.PRNGKey(0), inp), 1)
    ref = jm.apply(variables, inp, train=False)
    tm = _load(PointNet(in_channels=6), variables)
    got = tm({"feat": _t(feat), "valid": _t(valid)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_grouped_bn_relu_max_with_holes():
    rng = np.random.RandomState(1)
    B, N, M, K, D = 2, 40, 12, 5, 24
    g = rng.randn(B, N, D).astype(np.float32)
    h = rng.randn(B, M, D).astype(np.float32)
    nn_idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
    nn_idx[0, :4, 3:] = -1   # a few holes
    nn_idx[1, 5, :] = -1     # a token with holes only
    jm = jnn.GroupedBNReluMax()
    args = (jnp.asarray(g), jnp.asarray(h), jnp.asarray(nn_idx))
    variables = _randomize(jm.init(jax.random.PRNGKey(0), *args), 2)
    assert (np.asarray(variables["params"]["scale"]) < 0).any()  # min branch
    ref = jm.apply(variables, *args, use_running_average=True)
    tm = _load(tnn.GroupedBNReluMax(D), variables)
    got = tm(_t(g), _t(h), _t(nn_idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hidden", [32, 48])
def test_coord_embedding_sine(hidden):
    coord = (np.random.RandomState(hidden).rand(2, 20, 3) * 0.4 - 0.2).astype(np.float32)
    ref = jax_coord_embedding_sine(jnp.asarray(coord), hidden)
    got = coord_embedding_sine(_t(coord), hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sinusoid_table():
    np.testing.assert_allclose(tnn.get_sinusoid_encoding_table(12, 32).numpy(),
                               np.asarray(jnn.get_sinusoid_encoding_table(12, 32)),
                               atol=ATOL, rtol=0)


def _seq(seed, B, L, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L, D).astype(np.float32),
            rng.randn(B, L, D).astype(np.float32))


@pytest.mark.parametrize("L,pad", [(20, False), (20, True), (520, False)])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer(L, pad, normalize_before):
    # L=520 takes the oneshot route in the port; pad adds a key-padding mask
    D, H = 32, 4
    src, pos = _seq(L, 2, L, D)
    kpm = None
    if pad:
        kpm = np.zeros((2, L), bool)
        kpm[1, L - 6:] = True
    jm = jtr.TransformerEncoderLayer(D, H, dim_feedforward=16,
                                     normalize_before=normalize_before)
    jargs = (jnp.asarray(src), jnp.asarray(pos),
             None if kpm is None else jnp.asarray(kpm))
    variables = _randomize(jm.init(jax.random.PRNGKey(0), *jargs), 3)
    ref = jm.apply(variables, *jargs, deterministic=True)
    tm = _load(ttr.TransformerEncoderLayer(D, H, dim_feedforward=16,
                                           normalize_before=normalize_before),
               variables)
    got = tm(_t(src), _t(pos), None if kpm is None else _t(kpm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer(normalize_before):
    D, H, nq, L = 32, 4, 5, 30
    rng = np.random.RandomState(4)
    tgt = rng.randn(2, nq, D).astype(np.float32)
    qpos = rng.randn(2, nq, D).astype(np.float32)
    memory, pos = _seq(5, 2, L, D)
    jm = jtr.TransformerDecoderLayer(D, H, dim_feedforward=16,
                                     normalize_before=normalize_before)
    jargs = [jnp.asarray(a) for a in (tgt, memory, pos, qpos)]
    variables = _randomize(jm.init(jax.random.PRNGKey(0), *jargs), 5)
    ref = jm.apply(variables, *jargs, deterministic=True)
    tm = _load(ttr.TransformerDecoderLayer(D, H, dim_feedforward=16,
                                           normalize_before=normalize_before),
               variables)
    got = tm(*[_t(a) for a in (tgt, memory, pos, qpos)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("npoints,n_points", [(16, 256), (512, 1024)])
def test_actpcd_predict(npoints, n_points):
    """The whole predict path at hidden 32, 4 heads, 2 encoder layers, 3
    decoder layers (1 live), chunk 5, k 4. With 512 tokens the encoder's
    2+1+512 >= 512 keys take the oneshot route in the port."""
    dims = dict(hidden_dim=32, npoints=npoints, nsample=4, chunk=5,
                enc_layers=2, dec_layers=3, nhead=4)
    train_batch = jentry.build_batch(batch_size=2, n_points=n_points, chunk=5)
    policy = jentry.build_flagship(**dims)
    rng = jax.random.PRNGKey(0)
    # jitted, as the JAX BCModule.initial_state does: eager init dispatches
    # thousands of small ops
    variables = jax.jit(lambda b: policy.init(
        {"params": rng, "vae": rng, "dropout": rng}, b, train=True))(
        jax.tree.map(jnp.asarray, train_batch))
    variables = _randomize(variables, 6)
    obs = tentry.build_batch(batch_size=2, n_points=n_points, chunk=5,
                             with_actions=False)
    assert "actions" not in obs
    ref = np.asarray(JBCModule(policy).predict(
        variables, jax.tree.map(jnp.asarray, obs)))

    module = BCModule(tentry.build_flagship(**dims, device="cpu"))
    module.load_variables(variables)
    got = module.predict(obs)
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def _cloud(kind, rng):
    if kind == "random":
        return (rng.rand(3000, 3) * 0.4 - 0.2).astype(np.float32)
    if kind == "duplicates":  # equal codes: the stable order decides
        return np.repeat(rng.rand(50, 3).astype(np.float32), 7, axis=0)[rng.permutation(350)]
    if kind == "flat":  # zero extent on one axis
        c = rng.rand(500, 3).astype(np.float32)
        c[:, 1] = 0.5
        return c
    if kind == "single":
        return rng.rand(1, 3).astype(np.float32)
    return np.zeros((0, 3), np.float32)


@pytest.mark.parametrize("kind", ["random", "duplicates", "flat", "single", "empty"])
def test_morton_order_matches_jax_collate(kind):
    """The port keeps its own copy of the collate's Morton order (it imports
    nothing of the JAX package); the copy gives the same permutation."""
    cloud = _cloud(kind, np.random.RandomState(3))
    np.testing.assert_array_equal(tentry.morton_order(cloud), jax_morton_order(cloud))


@pytest.mark.parametrize("batch_size,n_points", [(1, 64), (3, 1000)])
def test_build_batch_matches_jax_entry(batch_size, n_points):
    """The port's synthetic batch is the JAX entry's, array for array."""
    ref = jentry.build_batch(batch_size=batch_size, n_points=n_points, chunk=5, seed=4)
    got = tentry.build_batch(batch_size=batch_size, n_points=n_points, chunk=5, seed=4)
    flat = lambda tree: {k: v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    ref, got = flat(ref), flat(got)
    assert ref.keys() == got.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=str(key))


def test_full_width_state_dict():
    """The published-scale JAX tree (abstract, no compute) converts onto the
    port's flagship state dict key for key and shape."""
    batch = jax.tree.map(jnp.asarray, jentry.build_batch(batch_size=1, n_points=4096))
    rng = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(lambda: jentry.build_flagship().init(
        {"params": rng, "vae": rng, "dropout": rng}, batch, train=True))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), abstract)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(variables["params"]))
    assert n_jax == FLAGSHIP_PARAMS

    model = tentry.build_flagship(device="cpu")
    target = model.state_dict()
    state = flax_to_torch(variables, model)
    assert set(state) == set(target)
    assert all(state[k].shape == target[k].shape for k in state)
    assert sum(p.numel() for p in model.parameters()) == FLAGSHIP_PARAMS


def test_converter_refuses_unmapped_and_missing():
    jm = JPointNet(in_channels=6)
    inp = {"feat": jnp.zeros((1, 4, 6)), "valid": jnp.ones((1, 4), bool)}
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), inp))
    target = PointNet(in_channels=6)
    extra = {"params": dict(variables["params"], odd={"thing": np.zeros(3)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="unmapped"):
        flax_to_torch(extra, target)
    fewer = {"params": {k: v for k, v in variables["params"].items() if k != "conv5"},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(fewer, target)
    with pytest.raises(TypeError, match="model"):  # a state dict cannot tell transposed kernels
        flax_to_torch(variables, target.state_dict())


def test_unported_backends_raise():
    """Every backend is ported: ``flash`` builds its core in the encoder and
    in the decoder's cross attention; ``fused`` builds its self-attention
    in the encoder and stays rejected by the decoder, as in JAX; a typo
    raises."""
    for layer in (ttr.TransformerEncoderLayer(32, 4, attention_impl="flash"),
                  ttr.TransformerDecoderLayer(32, 4, attention_impl="flash")):
        attn = getattr(layer, "multihead_attn", layer.self_attn)
        assert attn.attention_fn.__qualname__.startswith("make_flash_attention_fn")
    layer = ttr.TransformerEncoderLayer(32, 4, attention_impl="fused")
    assert isinstance(layer.self_attn, ttr.FusedSelfAttention)
    with pytest.raises(ValueError):
        ttr.TransformerDecoderLayer(32, 4, attention_impl="fused")
    with pytest.raises(ValueError):
        ttr.TransformerEncoderLayer(32, 4, attention_impl="flashh")
