"""The bf16 oneshot attention of the port against the JAX package's TPU
kernel, on the CPU, at the shapes the tensor-core kernels' tiling stresses,
and the ctypes signatures of the attention kernels' C entries.

- ``oneshot_attention`` on CPU tensors runs the plain bf16 versions
  (``oneshot_attention_plain`` / ``oneshot_attention_plain_bwd``), which the
  kernels of ``csrc/attention_mma.cuh`` are held to on the card. Here they
  are held to the JAX package's ``oneshot_attention`` (its Pallas forward
  and backward kernels, run in interpret mode: the tests hand that module a
  ``pl`` whose ``pallas_call`` interprets), forward and ``jax.grad``
  dq/dk/dv, within 2e-2 of each tensor's largest entry, as
  ``tests/test_torch_bf16.py`` holds the bf16 attention: both sides take
  bf16 operands with f32 sums and round at the same points, but in another
  summation order, which moves a rounded e or dS by a bf16 ulp (2^-8
  relative). Lq and Lk are not multiples of the 64-row tiles, dh is 64 or
  128, and the port's keys carry junk past ``l_actual`` (the JAX kernel
  gets only the first ``l_actual`` keys); the port's dk and dv there must be
  0. Dropout has no interpret-mode lowering (``prng_seed``), so it is
  tested at rate 0 here and on the card against the plain versions.
- A wrong ``argtypes`` cuts a pointer to 32 bits without an error, so the
  wrappers' ``argtypes`` are held to the ``extern "C"`` prototypes parsed
  from ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``, and those of
  the flash wrappers (``ops/flash_attention.py``) to the three entries of
  ``csrc/flash_attention.cu``, and those of the fused layer's wrappers
  (``ops/fused_mha.py``) to the two entries of ``csrc/fused_mha.cu``.
- ``chip_smoke.py`` finds each tensor-core kernel's (and the FP32 GEMM's)
  registers and spills in ptxas's output by a piece of its mangled name
  (``PTXAS_FUNCTIONS``), and fails on the card when a piece finds nothing.
  Each piece is held here to the sources: it names a ``__global__``
  function of the source that ``chip_smoke.KERNELS`` lists for the entry
  (or of a header it includes), and every other name in it (namespaces,
  template arguments) is in those sources too.
"""

import ctypes
import functools
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pointcloudmatters_tpu.ops import oneshot_attention as jone
from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops import flash_attention as tfa
from pointcloudmatters_tpu_torch.ops import fused_mha as tfm
from pointcloudmatters_tpu_torch.ops import oneshot_attention as tone

BF16 = torch.bfloat16
RTOL = 2e-2


class _Module(types.ModuleType):
    """A module with some attributes replaced."""

    def __init__(self, mod, **replaced):
        super().__init__(mod.__name__)
        self._mod = mod
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._mod, name)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX oneshot kernels in Pallas interpret mode."""
    pl = jone.pl
    monkeypatch.setattr(jone, "pl", _Module(
        pl, pallas_call=functools.partial(pl.pallas_call, interpret=True)))


def _rel(got, ref) -> float:
    got = np.asarray(got.detach().float(), np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1e-12, np.abs(ref).max()))


@pytest.mark.parametrize("Lq,Lk,l_actual", [(70, 515, 480), (130, 600, 577)])
@pytest.mark.parametrize("dh", [64, 128])
def test_bf16_plain_matches_jax_tpu_kernel(interpret, Lq, Lk, l_actual, dh):
    """Forward and dq/dk/dv of the port's bf16 oneshot attention (plain
    versions) against ``jax.grad`` through the JAX TPU kernels, keys past
    l_actual junk on the port's side."""
    B, H = 2, 2
    scale = dh ** -0.5
    rng = np.random.RandomState(Lq + Lk + dh)
    q, k, v = (rng.randn(B, H, L, dh).astype(np.float32) for L in (Lq, Lk, Lk))
    g = rng.randn(B, H, Lq, dh).astype(np.float32)
    k[:, :, l_actual:] *= 50.0
    v[:, :, l_actual:] *= 50.0

    def jloss(q, k, v):
        out = jone.oneshot_attention(q, k, v, 0, scale, 0.0, 256)
        return jnp.sum(out.astype(jnp.float32) * g), out

    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k[:, :, :l_actual], v[:, :, :l_actual])]
    (_, ref), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*jb)

    tq, tk, tv = (torch.from_numpy(a).to(BF16).requires_grad_() for a in (q, k, v))
    out = tone.oneshot_attention(tq, tk, tv, scale, l_actual=l_actual)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == BF16 and tq.grad.dtype == BF16
    assert _rel(out, ref) < RTOL
    assert _rel(tq.grad, ref_grads[0]) < RTOL, "dq"
    for name, got, want in (("dk", tk.grad, ref_grads[1]), ("dv", tv.grad, ref_grads[2])):
        assert _rel(got[:, :, :l_actual], want) < RTOL, name
        assert torch.count_nonzero(got[:, :, l_actual:]) == 0, name


_CTYPE_OF = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "unsigned": ctypes.c_uint32, "float": ctypes.c_float}


def _prototype(source: str, name: str) -> list:
    """ctypes kinds of the parameters of ``int name(...)`` in a csrc file."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    match = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", text)
    assert match, f"no prototype of {name} in {source}"
    kinds = []
    for param in match.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
            continue
        ctype = re.sub(r"\s*\w+$", "", param.replace("const ", ""))
        kinds.append(_CTYPE_OF[ctype])
    return kinds


class _FakeLib:
    """A loaded library whose entry points have no argtypes yet."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("getter,source,entry", [
    ("_fwd_lib", "attention_fwd.cu", "pcm_attention_fwd"),
    ("_bwd_lib", "attention_bwd.cu", "pcm_attention_bwd"),
    ("_lib", "flash_attention.cu", "pcm_flash_fwd"),
    ("_lib", "flash_attention.cu", "pcm_flash_bwd_dkv"),
    ("_lib", "flash_attention.cu", "pcm_flash_bwd_dq"),
    ("_lib", "fused_mha.cu", "pcm_fused_mha_fwd"),
    ("_lib", "fused_mha.cu", "pcm_fused_mha_bwd"),
])
def test_wrapper_argtypes_match_c_prototypes(monkeypatch, getter, source, entry):
    """The wrapper's argtypes have the C entry's length and, at every
    position, its kind: a pointer is c_void_p, never an int."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    module = {"flash_attention.cu": tfa, "fused_mha.cu": tfm}.get(source, tone)
    lib = getattr(module, getter)()
    fn = getattr(lib, entry)
    want = _prototype(source, entry)
    assert len(fn.argtypes) == len(want)
    for i, (got, kind) in enumerate(zip(fn.argtypes, want)):
        assert got is kind, f"{entry} argument {i}: {got.__name__} for {kind.__name__}"
    assert fn.restype is ctypes.c_int


def _sources(name: str, seen=None) -> list:
    """The text of csrc file ``name`` and of every csrc header it includes,
    comments removed."""
    seen = set() if seen is None else seen
    if name in seen:
        return []
    seen.add(name)
    with open(os.path.join(_build.CSRC, name)) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    texts = [text]
    for header in re.findall(r'#include "([\w.]+)"', text):
        texts += _sources(header, seen)
    return texts


def _mangled_names(piece: str, leading: bool = False) -> list:
    """The source-level names in a piece of an Itanium-mangled name, in
    order: literals (``Li64E``, ``Lb0E``) and substitutions (``S0_``,
    ``T0_``) dropped, then every <length><identifier>; with ``leading``
    only those before the first other character (the nested name of the
    function: its namespaces, then the function)."""
    piece = re.sub(r"L[a-z]+\d+E|[ST]\d*_", "", piece)
    names, i = [], 0
    while i < len(piece):
        m = re.match(r"\d+", piece[i:])
        if m:
            n = int(m.group())
            start = i + len(m.group())
            names.append(piece[start:start + n])
            i = start + n
        elif leading:
            break
        else:
            i += 1
    return names


@pytest.mark.parametrize("entry,tag", [
    (entry, tag) for entry, pieces in sorted(chip_smoke.PTXAS_FUNCTIONS.items())
    for tag in sorted(pieces)])
def test_ptxas_pieces_name_kernels_of_their_source(entry, tag):
    """A ``PTXAS_FUNCTIONS`` piece names a ``__global__`` function of its
    entry's source, and its other names occur there too."""
    piece = chip_smoke.PTXAS_FUNCTIONS[entry][tag]
    source = chip_smoke.KERNELS[entry][0]
    assert source.startswith(chip_smoke._CSRC), source
    texts = _sources(source[len(chip_smoke._CSRC):])
    kernels = {m for t in texts for m in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", t)}
    names = _mangled_names(piece)
    assert names, piece
    function = _mangled_names(piece, leading=True)[-1]
    assert function in kernels, f"{piece}: no __global__ {function} in {source}"
    for name in names:
        if name != function and name != "__nv_bfloat16":
            assert any(re.search(r"\b" + re.escape(name) + r"\b", t) for t in texts), \
                f"{piece}: {name} is not in {source}"
