"""The port's flash attention (``ops/flash_attention.py``), its adapter and
the ``attention_impl="flash"`` encoder against the JAX package's, on the CPU.

The JAX side runs its TPU kernels themselves (``flash_attention.py``
``_flash_attention_impl``, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``) in Pallas interpret mode: the tests hand that
module a ``pl`` whose ``pallas_call`` interprets, and hand the JAX adapter
module an ``_pallas_enabled`` that says yes, so that its flash adapter takes
its kernel route (padding to 512-row tiles, segment ids) while every other
dispatch of the JAX package keeps its XLA formulation. Dropout cannot run
in interpret mode (the TPU's random bits have no CPU lowering), so it is
tested on the port alone. Inputs come from numpy seeds.

Limits, each from the worst case measured on these inputs (in brackets)
with a margin:

- the op, f32: o, dq, dk, dv and ds within 1e-5 of max(1, max |ref|)
  [8.0e-7]; both sides take the same f32 steps in another summation order;
- the op, bf16: within 1e-2 [2.0e-3], one bf16 ulp (2^-8 relative) where a
  rounded p or dS flips, carried through a sum;
- the row statistics l and m within 1e-5 relative [3.0e-7];
- the adapter against the padded JAX adapter, f32, output and gradients
  within 1e-5 of max(1, max |ref|) [3.8e-7]; its dense fallbacks within
  1e-5 [7.2e-7];
- the plain forward and backward at dropout 0.1 against a dense autograd
  reference that applies the extracted mask: 1e-5 [3.6e-7];
- the policy's ``predict`` (f32) within 1e-4 of max(1, max |ref|)
  [4.5e-7];
- its steps at dropout 0: the loss within 1e-5 relative in f32 [4.3e-7]
  and 1e-2 in bf16 [2.2e-4], as ``tests/test_torch_bf16.py`` holds it; the
  transformer's gradients (the flash encoder and the decoder over it)
  within 1e-4 of their largest entry in f32 [1.9e-6] and 0.2 in bf16
  [0.092], the bf16 limit of ``tests/test_torch_bf16.py``; every other
  gradient within 1e-2 in f32 [1.1e-3, the backbone] and 0.4 in bf16
  [0.27, the CVAE posterior]: those tensors lie upstream of the flash
  encoder and carry the noise of the token selection and of ReLU flips
  at two batch rows. Measured against the f32 gradient, either side's bf16
  gradient is the farther one there, 0.21-0.33 off on ``build_batch`` seeds
  0-2 (the port's 0.23-0.26 on seed 0 where JAX's is 0.01-0.03, JAX's 0.33
  on seed 2 where the port's is 0.009), with the dense backend as with
  flash. The tensors whose exact gradient is 0 within 5e-3 of the model's
  largest gradient entry [4.9e-4].
"""

import functools

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
from pointcloudmatters_tpu.ops import attention as jattn
from pointcloudmatters_tpu.ops import flash_attention as jfa
from pointcloudmatters_tpu.trainer import _cast_floating
from pointcloudmatters_tpu_torch import entry as tentry
from pointcloudmatters_tpu_torch.models.bc_module import BCModule
from pointcloudmatters_tpu_torch.ops import attention as tattn
from pointcloudmatters_tpu_torch.ops import flash_attention as tfa
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone
from pointcloudmatters_tpu_torch.trainer import Trainer
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401
from test_torch_bf16 import _ZERO_GRAD, _common_patches
from test_torch_fused_mha import _Module, _rel

# the slice: 1024 point tokens + latent, proprio and goal = 1027 encoder rows,
# past the flash gate (min_seq_len 1024)
DIMS = dict(hidden_dim=64, npoints=1024, nsample=4, chunk=5, enc_layers=2,
            dec_layers=2, nhead=4)
N_POINTS = 2048  # every cloud keeps at least 1024 valid points


@pytest.fixture
def jax_flash_route(monkeypatch):
    """The JAX flash kernels in interpret mode, and the JAX adapter on its
    kernel route; counts the JAX op's calls."""
    calls = []
    pl = jfa.pl
    monkeypatch.setattr(jfa, "pl", _Module(
        pl, pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    monkeypatch.setattr(jattn, "_pallas_enabled", lambda: True)
    op = jattn.flash_attention
    monkeypatch.setattr(jattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    return calls


@pytest.fixture
def port_flash_calls(monkeypatch):
    calls = []
    op = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    return calls


def _err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|)."""
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _block_sizes(bq, bk):
    return jfa.BlockSizes(
        block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
        block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk, block_q_dkv=bq,
        block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)


# (B, H, L, dh, segment ids, causal, bias, block_k): a masked key tail and a
# query whose keys are all masked (its segment has no key); the causal tile
# skips; the bias and its gradient; the single-step variant (block_k = L);
# the bias and segment ids at the widths the bf16 tensor-core backward takes
# (dh 64 and 128)
CASES = {
    "plain": (2, 2, 256, 64, False, False, False, 128),
    "segments": (2, 2, 384, 16, True, False, False, 128),
    "causal": (1, 2, 384, 64, True, True, False, 128),
    "bias": (1, 2, 256, 16, False, True, True, 128),
    "single_step": (1, 2, 256, 64, True, False, True, 256),
    "bias_dh64": (1, 2, 256, 64, False, True, True, 128),
    "segments_dh128": (1, 2, 256, 128, True, False, False, 128),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernels(case, dtype, jax_flash_route):
    """The plain forward (o, l, m) and backward (dq, dk, dv, and ds with a
    bias) against ``jax.vjp`` through the JAX op's TPU kernels, 128-row
    blocks."""
    B, H, L, dh, seg, causal, bias, bk = CASES[case]
    rng = np.random.RandomState(L + dh)
    q, k, v, do = (rng.randn(B, H, L, dh).astype(np.float32) for _ in range(4))
    ab = (rng.randn(B, H, L, L) * 0.5).astype(np.float32) if bias else None
    ids = None
    if seg:
        kv = np.ones((B, L), np.int32)
        kv[:, L - 37:] = 0
        qi = np.ones((B, L), np.int32)
        qi[0, 5] = 2  # no key of segment 2: every key of row 5 is masked
        ids = (qi, kv)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-5 if dtype == "f32" else 1e-2
    scale = dh ** -0.5
    jseg = None if ids is None else jfa.SegmentIds(*map(jnp.asarray, ids))
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v) + ((ab,) if bias else ())]

    def jf(q, k, v, ab=None):
        return jfa.flash_attention(q, k, v, ab, jseg, causal=causal, sm_scale=scale,
                                   block_sizes=_block_sizes(128, bk))

    out, vjp = jax.vjp(jf, *jargs)
    ref_grads = vjp(jnp.asarray(do, jdt))
    _, jl, jm = jfa._flash_attention_impl(
        *jargs[:3], jargs[3] if bias else None, jseg, jnp.zeros((1,), jnp.int32), True,
        causal, scale, 0.0, 1, 128, bk, bk, False)

    t = lambda x: None if x is None else torch.from_numpy(x).to(tdt)  # noqa: E731
    tseg = None if ids is None else tfa.SegmentIds(*map(torch.from_numpy, ids))
    kw = dict(causal=causal, sm_scale=scale, block_q=128, block_k=bk)
    o, l, m = tfa.flash_attention_plain(t(q), t(k), t(v), t(ab), tseg, **kw)
    assert o.dtype == tdt and l.dtype == m.dtype == torch.float32
    assert _err(o, out) <= tol
    for got, ref in ((l, jl), (m, jm)):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    di = (o.float() * t(do).float()).sum(-1)
    args = (t(q), t(k), t(v), t(ab), tseg, l, m, t(do), di)
    dk, dv = tfa.flash_attention_plain_bwd_dkv(*args, **kw)
    dq, ds = tfa.flash_attention_plain_bwd_dq(*args, **kw)
    got = (dq, dk, dv) + ((ds,) if bias else ())
    assert (ds is None) == (not bias)
    for name, g, r in zip(("dq", "dk", "dv", "ds"), got, ref_grads):
        assert g.dtype == tdt and tuple(g.shape) == r.shape, name
        assert _err(g, r) <= tol, (name, _err(g, r))


def test_autograd_function_runs_plain_versions_on_cpu():
    """``flash_attention`` on CPU tensors: the plain forward, and gradients
    of q, k, v and the bias through the plain backward, with q, k, v given
    as (B, H, L, dh) views of (B, L, H, dh) tensors as the adapter passes
    them."""
    rng = np.random.RandomState(1)
    B, H, L, dh = 2, 2, 200, 16
    leaves = [torch.from_numpy(rng.randn(B, L, H, dh).astype(np.float32)).requires_grad_()
              for _ in range(3)]
    ab = torch.from_numpy(rng.randn(B, H, L, L).astype(np.float32)).requires_grad_()
    do = torch.from_numpy(rng.randn(B, H, L, dh).astype(np.float32))
    ids = tfa.SegmentIds(torch.ones((B, L), dtype=torch.int32),
                         (torch.arange(L) < 150).to(torch.int32).expand(B, L).contiguous())
    kw = dict(causal=True, sm_scale=0.25, dropout_rate=0.1, dropout_seed=3, block_q=64,
              block_k=64)
    q, k, v = (x.transpose(1, 2) for x in leaves)
    out = tfa.flash_attention(q, k, v, ab, ids, **kw)
    o, l, m = tfa.flash_attention_plain(q, k, v, ab, ids, **kw)
    torch.testing.assert_close(out, o, rtol=0, atol=0)
    out.backward(do)
    di = (o * do).sum(-1)
    args = (q.detach(), k.detach(), v.detach(), ab.detach(), ids, l, m, do, di)
    dk, dv = tfa.flash_attention_plain_bwd_dkv(*args, **kw)
    dq, ds = tfa.flash_attention_plain_bwd_dq(*args, **kw)
    for leaf, want in zip(leaves + [ab], (dq, dk, dv, ds)):
        grad = leaf.grad.transpose(1, 2) if leaf is not ab else leaf.grad
        torch.testing.assert_close(grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_adapter_matches_padded_jax_adapter(masked, jax_flash_route, port_flash_calls):
    """The port's unpadded adapter against the JAX adapter, which pads 1027
    rows to 1536 at 512-row tiles and masks the padded keys by segment ids:
    the output and the gradients of q, k, v, with and without a key-padding
    mask."""
    B, L, H, dh = 2, 1027, 2, 16
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(B, L, H, dh).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, 1, 1, L), bool)
        mask[0, ..., 900:] = False
        mask[1, ..., 3:40] = False
    jfn = jattn.make_flash_attention_fn()
    out, vjp = jax.vjp(lambda q, k, v: jfn(q, k, v, mask=None if mask is None
                                          else jnp.asarray(mask)), *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    assert len(jax_flash_route) == 1

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = tattn.make_flash_attention_fn()(
        *leaves, mask=None if mask is None else torch.from_numpy(mask))
    assert len(port_flash_calls) == 1
    assert _err(got, out) <= 1e-5
    got.backward(torch.from_numpy(do))
    for name, leaf, ref in zip("qkv", leaves, ref_grads):
        assert _err(leaf.grad, ref) <= 1e-5, name


@pytest.mark.parametrize("case", ["short", "bias", "query_mask"])
def test_adapter_dense_fallbacks(case, jax_flash_route, port_flash_calls):
    """JAX's gate, on every device: rows shorter than 1024 on either side, a
    bias, or a mask that is not a key-padding one take the dense math on
    both sides, which agree."""
    B, H, dh = 2, 2, 16
    Lq, Lk = (100, 1100) if case == "short" else (1030, 1030)
    rng = np.random.RandomState(8)
    q = rng.randn(B, Lq, H, dh).astype(np.float32)
    k, v = (rng.randn(B, Lk, H, dh).astype(np.float32) for _ in range(2))
    bias = rng.randn(B, H, Lq, Lk).astype(np.float32) if case == "bias" else None
    mask = rng.rand(B, 1, Lq, Lk) > 0.2 if case == "query_mask" else None
    kw = lambda f: dict(bias=None if bias is None else f(bias),  # noqa: E731
                        mask=None if mask is None else f(mask))
    ref = jattn.make_flash_attention_fn()(*map(jnp.asarray, (q, k, v)), **kw(jnp.asarray))
    got = tattn.make_flash_attention_fn()(*map(torch.from_numpy, (q, k, v)),
                                          **kw(torch.from_numpy))
    assert not jax_flash_route and not port_flash_calls
    assert _err(got, ref) <= 1e-5


def _read_mask(seed, B=2, H=3, Lq=512, Lk=64, block_k=32):
    """The dropout mask the plain forward applied, read back: q = 0 weighs
    every key alike and v = Lk I picks key j in column j, so o[b, h, i, j]
    is D_ij = keep_ij / keep."""
    q = torch.zeros((B, H, Lq, Lk))
    v = (torch.eye(Lk) * Lk).expand(B, H, Lk, Lk)
    o, _, _ = tfa.flash_attention_plain(q, torch.randn(B, H, Lk, Lk), v, dropout_rate=0.1,
                                        dropout_seed=seed, block_k=block_k)
    return o


@pytest.mark.parametrize("block_k", [32, 64])
def test_dropout_mask_shared_across_batch_and_heads(block_k):
    """The flash mask, read back from the plain forward (blocked and single
    step): the same for every batch item and head, ``flash_keep_mask`` bit
    for bit, survivors scaled by f32(1 / keep) with keep = 1 - threshold /
    2^32, a drop rate within 0.01 of 0.1, other bits for another seed, and
    not the oneshot mask of head 0 for the same seed."""
    o = _read_mask(11, block_k=block_k)
    keep = tfa.flash_keep_mask(11, 0.1, 512, 64)
    assert torch.equal(o != 0, keep.expand_as(o))
    inv_keep = 1.0 / (1.0 - min(int(0.1 * 2 ** 32), 2 ** 32 - 1) / 2 ** 32)
    assert torch.equal(o[o != 0], torch.full_like(o[o != 0], inv_keep))
    assert abs((~keep).float().mean().item() - 0.1) < 0.01
    assert (keep != tfa.flash_keep_mask(12, 0.1, 512, 64)).float().mean() > 0.1
    assert not torch.equal(keep, tone.keep_mask(11, 0.1, 1, 512, 64)[0])


def test_dropout_fwd_bwd_match_dense_with_extracted_mask():
    """The plain forward and backward at dropout 0.1 (blocked, with a masked
    key tail) equal a dense autograd reference that applies the mask read
    back from the forward."""
    B, H, L, dh, seed = 2, 2, 200, 16, 5
    drop = _read_mask(seed, 1, 1, L, L, block_k=64)[0, 0]
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, L, dh).astype(np.float32))
                   for _ in range(4))
    valid = (torch.arange(L) < 180).to(torch.int32).expand(B, L).contiguous()
    ids = tfa.SegmentIds(torch.ones((B, L), dtype=torch.int32), valid)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, segment_ids=ids, sm_scale=0.25, dropout_rate=0.1,
                              dropout_seed=seed, block_k=64)
    out.backward(do)

    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    s = ref_leaves[0] @ ref_leaves[1].transpose(-1, -2) * 0.25
    p = torch.softmax(torch.where(valid[:, None, None, :] == 1, s, -torch.inf), dim=-1)
    ref = (p * drop) @ ref_leaves[2]
    ref.backward(do)
    assert _err(out, ref.detach().numpy()) <= 1e-5
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert _err(a.grad, b.grad.numpy()) <= 1e-5, name


def _jax_policy():
    d = DIMS["hidden_dim"]
    return jact.ACTPCD(
        backbone=JPointNet(in_channels=6, num_classes=0),
        transformer=jtr.Transformer(
            d_model=d, nhead=DIMS["nhead"], num_encoder_layers=DIMS["enc_layers"],
            num_decoder_layers=DIMS["dec_layers"], dim_feedforward=32, dropout=0.0,
            normalize_before=False, return_intermediate_dec=True, attention_impl="flash"),
        encoder=jtr.TransformerEncoder(d_model=d, nhead=8, dim_feedforward=32,
                                       num_layers=DIMS["enc_layers"], dropout=0.0),
        hidden_dim=d, num_queries=DIMS["chunk"], num_cameras=0, action_dim=7, qpos_dim=9,
        goal_cond_dim=3, kl_weight=10.0, pcd_nsample=DIMS["nsample"],
        pcd_npoints=DIMS["npoints"],
    )


def _slice(batch, seed):
    """The JAX flash policy's variables (randomised) and the port's policy
    loaded from them."""
    jpolicy = _jax_policy()
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda b: jpolicy.init(
        {"params": key, "vae": key, "dropout": key}, b, train=True))(
        jax.tree.map(jnp.asarray, batch))
    variables = jax.tree.map(np.asarray, _randomize(variables, seed))
    module = BCModule(tentry.build_flagship(**DIMS, dropout=0.0, attention_impl="flash",
                                            device="cpu"))
    module.load_variables(variables)
    return jpolicy, variables, module


def test_flash_policy_predict_matches_jax(jax_flash_route, port_flash_calls):
    """``predict`` of the flash ACTPCD (f32, 1027 encoder rows) against the
    JAX policy on its kernel route; both run the flash op in every encoder
    layer."""
    batch = jentry.build_batch(batch_size=2, n_points=N_POINTS, chunk=DIMS["chunk"])
    obs = {k: v for k, v in batch.items() if k not in ("actions", "is_pad")}
    jpolicy, variables, module = _slice(batch, 5)
    jax_flash_route.clear()  # init traced the flash layers too
    ref = np.asarray(jax.jit(JBCModule(jpolicy).predict)(
        variables, jax.tree.map(jnp.asarray, obs)))
    assert len(jax_flash_route) == DIMS["enc_layers"]
    got = module.predict(obs)
    assert len(port_flash_calls) == DIMS["enc_layers"]
    assert got.shape == ref.shape
    assert _err(got, ref) <= 1e-4


@pytest.mark.parametrize("precision", ["32-true", "bf16-mixed"])
def test_flash_step_matches_jax(precision, jax_flash_route, port_flash_calls, monkeypatch):
    """One training step of the flash policy at dropout 0, port against JAX
    from the same variables and batch: the loss and every gradient (JAX's
    through the flash op's custom VJP, kernels 10 and 11), f32 and
    ``"bf16-mixed"``."""
    eps = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    _common_patches(monkeypatch, eps)
    batch = jentry.build_batch(batch_size=2, n_points=N_POINTS, chunk=DIMS["chunk"])
    batch["is_pad"] = np.arange(DIMS["chunk"])[None] >= np.array([[5], [3]])
    jpolicy, variables, module = _slice(batch, 7)
    jax_flash_route.clear()
    jmodule = JBCModule(jpolicy)
    jbatch = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    cast = ((lambda x: _cast_floating(x, jnp.bfloat16)) if precision == "bf16-mixed"
            else (lambda x: x))

    def loss_fn(params):
        out, _ = jmodule.apply_train(
            {"params": cast(params), "batch_stats": variables["batch_stats"]},
            cast(jbatch), rngs=jmodule.make_rngs(key))
        return out["loss"].astype(jnp.float32)

    ref_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    assert len(jax_flash_route) == DIMS["enc_layers"]
    got = Trainer(precision=precision, seed=0).train_step(module, batch)
    assert len(port_flash_calls) == DIMS["enc_layers"]
    loss_tol, flash_tol, other_tol = (1e-5, 1e-4, 1e-2) if precision == "32-true" \
        else (1e-2, 0.2, 0.4)
    assert abs(float(got["loss"]) - float(ref_loss)) <= loss_tol * abs(float(ref_loss))

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
            tol = flash_tol if name.startswith("transformer.") else other_tol
            assert _rel(p.grad, ref) < tol, name
