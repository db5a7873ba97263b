"""The port's fused attention layer (``ops/fused_mha.py``) and the
``attention_impl="fused"`` encoder against the JAX package's, on the CPU.

The JAX side runs its TPU kernels themselves (``fused_mha.py`` ``_fwd_rule``
and ``_bwd_rule``) in Pallas interpret mode: the tests hand that module a
``pl`` whose ``pallas_call`` interprets, and, for the model, hand the JAX
transformer module a ``jax`` whose ``default_backend()`` says ``"tpu"``, so
that ``FusedSelfAttention`` takes its kernel route while every other
dispatch of the JAX package (point ops, the oneshot core of the CVAE
encoder, the token builder, the trainer) keeps its XLA formulation. Dropout
cannot run in interpret mode (the TPU's random bits have no CPU lowering),
so it is tested on the port alone. Inputs come from numpy seeds.

Both sides round to bf16 at the same points and sum in another order, so a
rounding may flip by one bf16 ulp (2^-8 relative) and carry on. Limits, each
from the worst case measured on these inputs (in brackets) with a margin:

- the op, f32 inputs: output within 2e-3 of max(1, max |ref|) [5.5e-4], each
  gradient within 2e-3 of its largest entry [3.4e-4];
- the op, bf16 inputs: output within 1e-2 [3.1e-3], each gradient within
  2e-2 of its largest entry [4.8e-3];
- the key bias's gradient, whose exact value is 0 (softmax is invariant to
  a shift of a row's scores), holds rounding noise on both sides: within the
  limit above of the query bias's largest gradient entry instead;
- the fused forward at dropout 0.1 against the composed route (projections
  + the oneshot core, f32, which rounds nothing), and the fused layer
  against the dense one: 1e-2 of max |ref| [3.1e-3, 7.5e-4], the fused
  op's own bf16 roundings;
- the policy's ``predict`` (f32) within 1e-3 of max(1, max |ref|) [5.7e-5];
  its bf16-mixed step as ``tests/test_torch_bf16.py`` holds the oneshot
  step: loss within 1e-2 relative [4.5e-4], each gradient within 0.2 of its
  largest entry [0.088], the tensors whose exact gradient is 0 within 5e-3
  of the model's largest gradient entry [5.1e-4].
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from pointcloudmatters_tpu.models.bc_module import BCModule as JBCModule
from pointcloudmatters_tpu.models.components.act import act as jact
from pointcloudmatters_tpu.models.components.act import transformer as jtr
from pointcloudmatters_tpu.models.components.pcd_encoder.pointnet import (
    PointNet as JPointNet,
)
from pointcloudmatters_tpu.ops import fused_mha as jfm
from pointcloudmatters_tpu.trainer import _cast_floating
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.models.components.act import transformer as ttr
from pointcloudmatters_tpu_torch.ops import attention as tattn
from pointcloudmatters_tpu_torch.ops import fused_mha as tfm
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401
from test_torch_bf16 import _ZERO_GRAD, _common_patches

GRADS = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo")
# the slice: >= 509 point tokens so that the encoder reaches the fused gate
DIMS = dict(hidden_dim=64, npoints=512, nsample=4, chunk=5, enc_layers=2,
            dec_layers=2, nhead=4)
N_POINTS = 1024


class _Module(types.ModuleType):
    """A module with some attributes replaced."""

    def __init__(self, mod, **replaced):
        super().__init__(mod.__name__)
        self._mod = mod
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """The JAX fused kernels in interpret mode, and JAX's FusedSelfAttention
    on its kernel route; counts the JAX op's calls."""
    calls = []
    pl = jfm.pl
    monkeypatch.setattr(jfm, "pl", _Module(
        pl, pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    monkeypatch.setattr(jtr, "jax", _Module(jax, default_backend=lambda: "tpu"))
    op = jfm.fused_mha
    monkeypatch.setattr(jfm, "fused_mha", lambda *a: calls.append(1) or op(*a))
    return calls


def _rel(got, ref) -> float:
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1e-30, np.abs(ref).max()))


def _op_inputs(B, L, D, seed):
    """x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo and a cotangent, f32 numpy."""
    rng = np.random.RandomState(seed)
    x = [rng.randn(B, L, D).astype(np.float32) for _ in range(2)]
    wb = [a for _ in range(4) for a in ((rng.randn(D, D) * D ** -0.5).astype(np.float32),
                                        (rng.randn(D) * 0.2).astype(np.float32))]
    return x + wb, rng.randn(B, L, D).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,H,B,L", [
    (64, 4, 1, 300), (64, 4, 2, 600), (128, 2, 1, 300), (128, 2, 2, 600),
    (256, 2, 1, 300),  # dh = 128, which the kernels take beside 64
])
def test_plain_matches_jax_kernels(D, H, B, L, dtype, jax_kernel_route):
    """The plain forward and all ten gradients of the plain backward against
    ``jax.vjp`` through the JAX op's TPU kernels (L = 300: two query tiles
    and padded keys there; L = 600 at B = 2), at dh 16, 64 and 128."""
    args, g = _op_inputs(B, L, D, seed=L + D)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    fwd_tol, grad_tol = (2e-3, 2e-3) if dtype == "f32" else (1e-2, 2e-2)
    seed = jnp.zeros((1,), jnp.int32)
    out, vjp = jax.vjp(lambda *a: jfm.fused_mha(*a, seed, H, 0.0),
                       *[jnp.asarray(a, jdt) for a in args])
    ref_grads = [np.asarray(r, np.float32) for r in vjp(jnp.asarray(g, jdt))]

    targs = [torch.from_numpy(a).to(tdt) for a in args]
    got = tfm.fused_mha_plain(*targs, H)
    ref = np.asarray(out, np.float32)
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - ref).max() <= fwd_tol * max(1.0, np.abs(ref).max())
    grads = tfm.fused_mha_plain_bwd(*targs, torch.from_numpy(g).to(tdt), H)
    dbq_max = np.abs(ref_grads[GRADS.index("dbq")]).max()
    for name, got_g, ref_g in zip(GRADS, grads, ref_grads):
        assert got_g.dtype == tdt and tuple(got_g.shape) == ref_g.shape, name
        err = np.abs(got_g.float().numpy() - ref_g).max()
        scale = dbq_max if name == "dbk" else np.abs(ref_g).max()
        assert err <= grad_tol * scale, (name, err, scale)


def test_autograd_function_runs_plain_versions_on_cpu():
    """``fused_mha`` on CPU tensors: the plain forward, and gradients that
    reach every tensor argument through the plain backward, with weights
    given as ``nn.Linear.weight.t()`` views as the module passes them."""
    args, g = _op_inputs(2, 40, 64, seed=1)
    targs = [torch.from_numpy(a) for a in args]
    leaves = [torch.from_numpy(np.ascontiguousarray(a.T)).requires_grad_() if a.ndim == 2
              else torch.from_numpy(a).requires_grad_() for a in args]
    inputs = [t.t() if t.ndim == 2 else t for t in leaves]
    out = tfm.fused_mha(*inputs, 4)
    torch.testing.assert_close(out, tfm.fused_mha_plain(*targs, 4), rtol=0, atol=0)
    out.backward(torch.from_numpy(g))
    want = tfm.fused_mha_plain_bwd(*targs, torch.from_numpy(g), 4)
    for name, leaf, w in zip(GRADS, leaves, want):
        got = leaf.grad.t() if leaf.ndim == 2 else leaf.grad
        torch.testing.assert_close(got, w, rtol=0, atol=0, msg=name)


def test_dropout_matches_composed_route():
    """At dropout 0.1 the fused op and the composed route (projections + the
    oneshot core) draw the same mask from the same seed: outputs agree to
    the fused op's bf16 roundings, and not with another seed."""
    B, L, D, H, rate = 2, 130, 64, 2, 0.1
    args, _ = _op_inputs(B, L, D, seed=3)
    x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo = (torch.from_numpy(a) for a in args)

    def composed(seed):
        heads = lambda t: t.view(B, L, H, D // H).transpose(1, 2)  # noqa: E731
        o = tone.oneshot_attention_plain(heads(x_qk @ wq + bq), heads(x_qk @ wk + bk),
                                         heads(x_v @ wv + bv), (D // H) ** -0.5,
                                         rate=rate, seed=seed)
        return o.transpose(1, 2).reshape(B, L, D) @ wo + bo

    got = tfm.fused_mha_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, H, rate, 9)
    ref = composed(9)
    assert _rel(got, ref.numpy()) < 1e-2
    assert _rel(composed(10), ref.numpy()) > 0.1


def test_dropout_mask_shared_across_batch_distinct_per_head():
    """The fused op's dropout mask, read back: q = 0 weighs every key
    1 / L, v = one-hot rows pick a key a column, so each output entry is
    keep / (L (1 - rate)); the mask is the same for every batch item, is
    ``keep_mask`` of each head, and differs between heads."""
    L = D = 64
    H, rate, seed = 4, 0.1, 77
    eye = torch.eye(D)
    zero, zb = torch.zeros(D, D), torch.zeros(D)
    x_v = eye.expand(2, L, D).contiguous()
    x_qk = torch.randn(2, L, D, generator=torch.Generator().manual_seed(0))
    out = tfm.fused_mha_plain(x_qk, x_v, zero, zb, zero, zb, eye, zb, eye, zb, H, rate, seed)
    read = torch.round(out * (L * (1.0 - rate))).to(torch.int64)
    assert torch.equal(read[0], read[1])
    mask = tone.keep_mask(seed, rate, H, L, L).to(torch.int64)
    dh = D // H
    for h in range(H):
        assert torch.equal(read[0][:, h * dh:(h + 1) * dh], mask[h][:, h * dh:(h + 1) * dh])
    assert not torch.equal(mask[0], mask[1])
    assert 0.85 < mask.float().mean().item() < 0.95


def _jax_layer(impl):
    return jtr.TransformerEncoderLayer(d_model=64, nhead=4, dim_feedforward=32,
                                       dropout=0.0, attention_impl=impl)


def test_parameter_tree_and_checkpoint_load():
    """The fused backend's parameter tree is the dense and oneshot
    backends' in both packages, and a JAX checkpoint of a fused layer loads
    through ``flax_to_torch`` into the port's fused layer, which then
    computes what the port's dense layer computes from it (to the fused
    op's bf16 roundings)."""
    x = np.random.RandomState(0).randn(2, 520, 64).astype(np.float32)
    shapes = {}
    for impl in ("dense", "oneshot", "fused"):
        variables = jax.jit(_jax_layer(impl).init)(jax.random.PRNGKey(0), jnp.asarray(x))
        shapes[impl] = jax.tree.map(np.shape, variables)
    assert shapes["fused"] == shapes["dense"] == shapes["oneshot"]
    torch_keys = {impl: {k: tuple(v.shape) for k, v in ttr.TransformerEncoderLayer(
        64, 4, 32, 0.0, attention_impl=impl).state_dict().items()}
        for impl in ("dense", "oneshot", "fused")}
    assert torch_keys["fused"] == torch_keys["dense"] == torch_keys["oneshot"]

    variables = _randomize(jax.tree.map(np.asarray, jax.jit(_jax_layer("fused").init)(
        jax.random.PRNGKey(1), jnp.asarray(x))), 2)
    layers = {}
    for impl in ("fused", "dense"):
        layer = ttr.TransformerEncoderLayer(64, 4, 32, 0.0, attention_impl=impl).eval()
        layer.load_state_dict(flax_to_torch(variables, layer), strict=True)
        layers[impl] = layer
    assert isinstance(layers["fused"].self_attn, ttr.FusedSelfAttention)
    with torch.no_grad():
        got, ref = (layers[i](torch.from_numpy(x)) for i in ("fused", "dense"))
    assert _rel(got, ref.numpy()) < 1e-2


@pytest.mark.parametrize("case", ["fused", "dropout", "mask", "short", "cross"])
def test_fused_self_attention_routes(case, monkeypatch):
    """JAX's gate, on every device: the one-kernel layer only with no mask,
    L >= 512, no dropout and the key input the query input itself; the
    oneshot core (dropout with a kernel seed) for the other unmasked long
    rows; the dense math otherwise."""
    taken = []
    fused, oneshot = ttr.fused_mha, tattn.oneshot_attention
    monkeypatch.setattr(ttr, "fused_mha", lambda *a: taken.append("fused") or fused(*a))
    monkeypatch.setattr(tattn, "oneshot_attention",
                        lambda *a, **k: taken.append("oneshot") or oneshot(*a, **k))
    attn = ttr.FusedSelfAttention(64, 4, dropout_rate=0.1)
    L = 100 if case == "short" else 512
    x = torch.randn(2, L, 64, generator=torch.Generator().manual_seed(0))
    rngs = {"dropout": torch.Generator().manual_seed(1),
            "seed": torch.Generator().manual_seed(2)}
    mask = torch.ones(2, 1, 1, L, dtype=torch.bool) if case == "mask" else None
    k = x.clone() if case == "cross" else x
    out = attn(x, k, x, mask=mask, deterministic=case != "dropout", rngs=rngs)
    assert out.shape == x.shape
    want = {"fused": ["fused"], "dropout": ["oneshot"], "cross": ["oneshot"]}.get(case, [])
    assert taken == want
    if case == "cross":  # the composed route computes the same layer
        ref = tfm.fused_mha_plain(x, x, *[t for lin in (attn.query, attn.key, attn.value,
                                                         attn.out)
                                          for t in (lin.weight.detach().t(),
                                                    lin.bias.detach())], 4)
        assert _rel(out, ref.numpy()) < 1e-2


def _jax_policy():
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6, num_classes=0),
        transformer=jtr.Transformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="fused"),
        encoder=jtr.TransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                       num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"],
    )


def _slice(batch, seed):
    """The JAX fused policy's variables (randomised) and the port's policy
    loaded from them."""
    jpolicy = _jax_policy()
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(
        jax.tree.map(jnp.asarray, batch))
    variables = jax.tree.map(np.asarray, _randomize(variables, seed))
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, attention_impl="fused",
                                            device="cpu"))
    module.load_variables(variables)
    return jpolicy, variables, module


@pytest.fixture
def port_fused_calls(monkeypatch):
    calls = []
    op = ttr.fused_mha
    monkeypatch.setattr(ttr, "fused_mha", lambda *a: calls.append(1) or op(*a))
    return calls


def test_fused_policy_predict_matches_jax(jax_kernel_route, port_fused_calls):
    """``predict`` of the fused ACTPCD (f32, 515 encoder tokens) against the
    JAX policy on its kernel route; both run the fused op in every encoder
    layer."""
    batch = jentry.build_batch(batch_size=2, n_points=N_POINTS, chunk=DIMS["chunk"])
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    jpolicy, variables, module = _slice(batch, 5)
    jax_kernel_route.clear()  # init traced the fused layers too
    ref = np.asarray(jax.jit(JBCModule(jpolicy).predict)(
        variables, jax.tree.map(jnp.asarray, obs)))
    assert len(jax_kernel_route) == DIMS["enc_layers"]
    got = module.predict(obs)
    assert len(port_fused_calls) == DIMS["enc_layers"]
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())


def test_fused_bf16_step_matches_jax(jax_kernel_route, port_fused_calls, monkeypatch):
    """One ``Trainer(precision="bf16-mixed")`` step of the fused policy at
    dropout 0, port against JAX from the same variables and batch: the loss
    and every gradient (JAX's through the fused op's custom VJP, kernel 8),
    held as ``tests/test_torch_bf16.py`` holds the oneshot step."""
    eps = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    _common_patches(monkeypatch, eps)
    batch = jentry.build_batch(batch_size=2, n_points=N_POINTS, chunk=DIMS["chunk"])
    batch["is_pad"] = np.arange(DIMS["chunk"])[None] >= np.array([[5], [3]])
    jpolicy, variables, module = _slice(batch, 7)
    jax_kernel_route.clear()
    jmodule = JBCModule(jpolicy)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        out, _ = jmodule.apply_train(
            {"params": _cast_floating(params, jnp.bfloat16),
             "batch_stats": variables["batch_stats"]},
            _cast_floating(jbatch, jnp.bfloat16), rngs=jmodule.make_rngs(key))
        return out["loss"].astype(jnp.float32)

    ref_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    assert len(jax_kernel_route) == DIMS["enc_layers"]
    got = Trainer(precision="bf16-mixed", seed=0).train_step(module, batch)
    assert len(port_fused_calls) == DIMS["enc_layers"]
    assert abs(float(got["loss"]) - float(ref_loss)) <= 1e-2 * abs(float(ref_loss))

    ref_grads = {k: v.numpy() for k, v in flax_to_torch(
        {"params": jgrads, "batch_stats": variables["batch_stats"]},
        module.policy).items()}
    g_max = max(np.abs(g).max() for g in ref_grads.values())
    for name, p in module.policy.named_parameters():
        ref = ref_grads[name]
        if np.abs(ref).max() == 0:  # off the path
            assert not p.grad.any(), name
        elif any(k in name for k in _ZERO_GRAD):
            assert max(np.abs(ref).max(), p.grad.abs().max().item()) <= 5e-3 * g_max, name
        else:
            assert _rel(p.grad, ref) < 0.2, name
