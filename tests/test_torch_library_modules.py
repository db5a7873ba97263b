"""The library-only modules of the port against the JAX package's, on the
CPU: ``nn_utils.FrozenBatchNorm`` and ``nn_utils.MLP``,
``TransformerForDiffusion``, the packed collates, ``ExperienceSourceDataset``,
``DataLoader.set_epoch``, ``utils/io.py``'s helpers and the TensorBoard
logger's ``log_video``. No config composes any of them, in the reference
too.

Modules are held within 1e-5 of JAX's outputs on the same randomised
variables (f32, summation order only); ``TransformerForDiffusion`` also in
its gradients (a dozen layers deep: 1e-5 of each tensor's largest entry),
in its three forms (the time token and observation tokens as the decoder's
memory through an MLP, through an encoder layer with a causal decoder, and
the encoder-only form). The data and IO helpers give what JAX's give.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudmatters_tpu.data import collate as jcollate
from pointcloudmatters_tpu.data import loader as jloader
from pointcloudmatters_tpu.data.components import misc as jmisc
from pointcloudmatters_tpu.models.components import nn_utils as jnn
from pointcloudmatters_tpu.models.components.diffusion_policy.diffusion import (
    transformer_for_diffusion as jtfd,
)
from pointcloudmatters_tpu.utils import io as jio
from pointcloudmatters_tpu.utils import loggers as jloggers
from pointcloudmatters_tpu_torch.data import collate as tcollate
from pointcloudmatters_tpu_torch.data import loader as tloader
from pointcloudmatters_tpu_torch.data.components import misc as tmisc
from pointcloudmatters_tpu_torch.models.components import nn_utils as tnn
from pointcloudmatters_tpu_torch.models.components.diffusion_policy.diffusion import (
    transformer_for_diffusion as ttfd,
)
from pointcloudmatters_tpu_torch.utils import io as tio
from pointcloudmatters_tpu_torch.utils import loggers as tloggers
from pointcloudmatters_tpu_torch.utils.flax_to_torch import flax_to_torch
from test_torch_act_slice import _randomize, threefry_prng  # noqa: F401


def _random_tables(variables, seed):
    """``_randomize`` and random position tables (flax initialises them to 0)."""
    rng = np.random.RandomState(seed)
    variables = _randomize(variables, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.randn(*np.shape(x)) * 0.5).astype(np.float32)
        if path[-1].key in ("pos_emb", "cond_pos_emb") else np.asarray(x), variables)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_frozen_batch_norm(dtype):
    x = np.random.RandomState(0).randn(4, 5, 6).astype(np.float32)
    jm = jnn.FrozenBatchNorm(dtype=None if dtype is None else jnp.bfloat16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(1)
    stats = {"mean": rng.randn(6), "var": rng.uniform(0.5, 2.0, 6), "scale": rng.randn(6),
             "bias": rng.randn(6)}
    variables = {"batch_stats": {k: v.astype(np.float32) for k, v in stats.items()}}
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    tm = tnn.FrozenBatchNorm(6, dtype=dtype)
    assert not list(tm.parameters())  # no optimizer sees it
    tm.load_state_dict(flax_to_torch({"params": {}, **variables}, tm), strict=True)
    got = tm(torch.from_numpy(x))
    assert got.dtype == (dtype or torch.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5 if dtype is None else 0,
                               rtol=0)
    assert tm(torch.from_numpy(x).to(torch.bfloat16)).dtype == (dtype or torch.bfloat16)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_mlp(num_layers):
    x = np.random.RandomState(2).randn(3, 7).astype(np.float32)
    jm = jnn.MLP(hidden_dim=16, output_dim=5, num_layers=num_layers)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tnn.MLP(7, 16, 5, num_layers)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-5, rtol=0)
    assert tnn.MLP(7, 16, 5, num_layers, dtype=torch.bfloat16)(
        torch.from_numpy(x)).dtype == torch.bfloat16


TFD = {
    "memory-mlp": dict(n_obs_steps=2, cond_dim=5, n_layer=2, n_head=2, n_emb=16),
    "memory-encoder-causal": dict(n_obs_steps=2, cond_dim=5, n_layer=1, n_head=4, n_emb=16,
                                  n_cond_layers=1, causal_attn=True),
    "encoder-only-causal": dict(n_layer=2, n_head=2, n_emb=16, time_as_cond=False,
                                causal_attn=True),
}


@pytest.mark.parametrize("form", list(TFD))
def test_transformer_for_diffusion(form):
    kw = dict(input_dim=4, output_dim=3, horizon=6, p_drop_emb=0.0, p_drop_attn=0.0,
              **TFD[form])
    rng = np.random.RandomState(4)
    sample = rng.randn(2, 6, 4).astype(np.float32)
    timestep = np.array([3, 71], np.int32)
    cond = rng.randn(2, 2, 5).astype(np.float32) if kw.get("cond_dim") else None
    jm = jtfd.TransformerForDiffusion(**kw)
    args = (jnp.asarray(sample), jnp.asarray(timestep),
            None if cond is None else jnp.asarray(cond))
    variables = _random_tables(jm.init(jax.random.PRNGKey(0), *args), 5)

    def jloss(params):
        return jnp.sum(jm.apply({"params": params}, *args) ** 2)

    ref = np.asarray(jax.jit(jm.apply)(variables, *args))
    ref_grads = jax.jit(jax.grad(jloss))(variables["params"])
    tm = ttfd.TransformerForDiffusion(**kw)
    tm.load_state_dict(flax_to_torch(variables, tm), strict=True)
    out = tm(torch.from_numpy(sample), torch.from_numpy(timestep),
             None if cond is None else torch.from_numpy(cond))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    (out ** 2).sum().backward()
    want = flax_to_torch({"params": jax.tree.map(np.asarray, ref_grads)}, tm)
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=name)


def test_transformer_for_diffusion_dropout_needs_a_generator():
    tm = ttfd.TransformerForDiffusion(input_dim=4, output_dim=3, horizon=6, n_layer=1,
                                      n_head=2, n_emb=8, n_obs_steps=1)
    x = torch.randn(2, 6, 4)
    torch.testing.assert_close(tm(x, 5), tm(x, torch.tensor([5, 5])))
    with pytest.raises(ValueError, match="rngs"):
        tm(x, 5, train=True)
    gen = lambda: {"dropout": torch.Generator().manual_seed(0)}  # noqa: E731
    torch.testing.assert_close(tm(x, 5, train=True, rngs=gen()), tm(x, 5, train=True, rngs=gen()))
    assert not torch.equal(tm(x, 5, train=True, rngs=gen()), tm(x, 5))


# ---------------------------------------------------------------------------
# data and IO
# ---------------------------------------------------------------------------

def _packed_samples():
    rng = np.random.RandomState(6)
    out = []
    for n_clouds, lengths in ((2, (5, 3)), (2, (4, 6))):
        out.append({"qpos": rng.randn(9).astype(np.float32), "name": f"s{n_clouds}",
                    "pcds": [{"coord": rng.rand(n, 3).astype(np.float32),
                              "feat": rng.rand(n, 6).astype(np.float32),
                              "offset": np.array([n])} for n in lengths]})
    return out


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list) and a and not isinstance(a[0], str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype


def test_packed_collates_match_jax():
    got, ref = tcollate.pcd_collate_fn(_packed_samples()), jcollate.pcd_collate_fn(
        _packed_samples())
    _equal(got, ref)
    np.testing.assert_array_equal(got["pcds"]["offset"], [5, 8, 12, 18])
    nested = [{"obs": {"pcds": s["pcds"], "qpos": s["qpos"]}} for s in _packed_samples()]
    _equal(tcollate.pcd_collate_fn(nested), jcollate.pcd_collate_fn(nested))
    flat = [{"qpos": s["qpos"]} for s in _packed_samples()]
    _equal(tcollate.pcd_collate_fn(flat), jcollate.pcd_collate_fn(flat))
    seqs = [[np.ones((3, 2)), np.zeros((3,))], [np.ones((4, 2)), np.zeros((4,))]]
    _equal(tcollate.point_collate_fn(seqs), jcollate.point_collate_fn(seqs))
    with pytest.raises(TypeError):
        tcollate.point_collate_fn(np.zeros(3))


def test_experience_source_dataset_and_set_epoch():
    def generate():
        yield from range(3)

    ds, jds = tmisc.ExperienceSourceDataset(generate), jmisc.ExperienceSourceDataset(generate)
    assert list(ds) == list(ds) == list(jds) == [0, 1, 2]
    data = list(range(10))
    loader = tloader.DataLoader(data, batch_size=3, shuffle=True, seed=5)
    jl = jloader.DataLoader(data, batch_size=3, shuffle=True, seed=5, process_count=1)
    loader.set_epoch(4)
    jl.set_epoch(4)
    got, ref = [b.tolist() for b in loader], [b.tolist() for b in jl]
    perm = np.arange(10)
    np.random.RandomState(5 + 4).shuffle(perm)
    assert got == ref == [perm[i:i + 3].tolist() for i in range(0, 10, 3)]
    assert loader.epoch == 5  # the next epoch counts on


def test_io_helpers_match_jax(tmp_path):
    obj = {"a": [1, 2.5], "b": "x"}
    tio.save_json(obj, str(tmp_path / "t.json"), indent=2)
    jio.save_json(obj, str(tmp_path / "j.json"), indent=2)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tio.load_json(str(tmp_path / "t.json")) == obj
    tio.save_pickle({"w": np.arange(3)}, str(tmp_path / "p.pkl"))
    np.testing.assert_array_equal(jio.load_pickle(str(tmp_path / "p.pkl"))["w"], np.arange(3))
    np.testing.assert_array_equal(tio.load_pickle(str(tmp_path / "p.pkl"))["w"], np.arange(3))
    np.save(tmp_path / "e.npy", np.array({"k": 1}, dtype=object), allow_pickle=True)
    assert tio.load_npy(str(tmp_path / "e.npy")).item() == {"k": 1}
    with pytest.raises(ValueError):
        tio.load_npy(str(tmp_path / "e.npy"), allow_pickle=False)
    assert tio.listdir(str(tmp_path)) == jio.listdir(str(tmp_path)) == sorted(
        os.listdir(tmp_path))
    json.loads((tmp_path / "t.json").read_text())


class _Writer:
    def __init__(self):
        self.calls = []

    def add_video(self, tag, video, step, fps=20):
        self.calls.append((tag, np.asarray(video), step, fps))

    def flush(self):
        pass

    def close(self):
        pass


def test_log_video_matches_jax(tmp_path):
    frames = np.random.RandomState(0).randint(0, 255, (4, 3, 8, 8)).astype(np.uint8)
    # the writer is a recorder: no event file, no video encoder needed
    loggers = [cls.__new__(cls) for cls in (tloggers.TensorBoardLogger,
                                            jloggers.TensorBoardLogger)]
    for lg in loggers:
        lg.prefix, lg._writer = "", _Writer()
        lg.log_video("rollout", frames, 7, fps=10)
    (tag, video, step, fps), ref = loggers[0]._writer.calls[0], loggers[1]._writer.calls[0]
    assert (tag, step, fps) == ref[:1] + ref[2:] == ("rollout", 7, 10)
    assert video.shape == (1, 4, 3, 8, 8)
    np.testing.assert_array_equal(video, ref[1])
    csv_only = tloggers.TensorBoardLogger.__new__(tloggers.TensorBoardLogger)
    csv_only._writer = None
    csv_only.log_video("rollout", frames, 7)  # the CSV fallback logs no video
