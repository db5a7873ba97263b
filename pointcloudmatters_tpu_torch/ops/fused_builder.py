"""The data-source token builder with a scatter-free backward (port of
``grouped_stats_data`` in ``pointcloudmatters_tpu/ops/fused_builder.py``).

For source rows ``src`` (B, N, Cin), a projection ``W`` (Cin, D), projected
query offsets ``h`` (B, M, D) and kNN indices ``nn_idx`` (B, M, K) int32
(-1 = hole), :func:`grouped_stats_data` returns the statistics the token
builder ``GroupedBNReluMax`` needs of ``x = (src @ W)[nn] - h``:

    vmax[m] = max over the live k of x[m, k]   (-inf for holes only)
    vmin[m] = min over the live k of x[m, k]   (+inf for holes only)
    total, total_sq = f32 sums over the live (m, k) of x and x * x

without the (B, M, K, D) neighbourhood tensor on the card. Its backward owes
no ``src`` cotangent (the rows are data: ``pre_sample`` clouds, frozen
backbones), so dW factorises into a tie-routed term over the forward's tie
bitmaps plus small dense terms, and ``h`` gets a closed-form cotangent
(the JAX module's derivation, ``fused_builder.py:43-68``):

    dW = routed(src[nn], ties, dvmax / cnt_max, dvmin / cnt_min)       (1)
       + 2 sum_n r_n src[n] (x) (g[n] * d_total_sq)                     (2)
       - 2 sum_m s_m (x) (h[m] * d_total_sq)                            (3)
       + (sum_{m,k} src[nn]) (x) d_total                                (4)

with r_n the multiplicity of source row n among the indices and
``s_m = sum_k src[nn[m, k]]``. Ties split the gradient evenly among tied
neighbours, as ``jnp.max``'s VJP does.

Kernels, each beside its plain version (a CPU tensor runs the plain
version, a CUDA tensor the kernel, which raises on what it does not take):

- kernel 5, the forward statistics (``csrc/fused_builder.cu``,
  ``builder_fwd_kernel``; plain: :func:`builder_core_plain`, the JAX
  ``_core_xla``), bf16 only;
- kernel 6, term (1) (``routed_dw_kernel``, on the bf16 tensor cores;
  plain: :func:`routed_dw_plain`, the JAX ``_routed_dw_xla``), bf16 inputs,
  w and the sums f32. The kernel reads the source rows at a pitch of a
  multiple of 8 channels: :func:`pad_channels` pads them as the JAX
  backward does (to a multiple of 16), once a backward.

Terms (2)-(4), the histogram and ``dh`` are plain torch, as the JAX package
leaves them to XLA. Rounding follows the JAX backward: the source rows of
terms (1), (3) and (4) and the routed cotangents are bf16 in every
precision (``fused_builder.py:474, 489-490``). Not ported: the TPU kernel's
query sort, chunk transpose and bf16-pair packing, devices of its memory
system that leave the function unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudmatters_tpu_torch import _build
from pointcloudmatters_tpu_torch.ops.pointops import gather_rows_padded

__all__ = [
    "fused_builder_supported",
    "popcount16",
    "builder_core_plain",
    "builder_core_cuda",
    "routed_dw_plain",
    "routed_dw_cuda",
    "routed_dw_splits",
    "pad_channels",
    "grouped_stats_data",
    "sum_sq_f32",
    "LAUNCHES",
    "ROUTED_LAUNCHES",
]

# launches of kernel 5 (forward) and kernel 6 (routed dW) in this process;
# a caller may reset them to 0
LAUNCHES = 0
ROUTED_LAUNCHES = 0

_LANES = 128
_MAX_K = 16
# stages of 4 (b, m) pairs (128 gathered rows at K = 16) between two flushes
# of kernel 6's stage sums into its f32 accumulators (``kFlush`` of
# csrc/fused_builder.cu, which this must equal), and its splits of the (b, m) pairs: SPLIT_GROUP splits a SPLIT_PAIRS pairs,
# 660 blocks at the flagship's 20 tiles of dW (Cin = 515, D = 512), whole
# waves of one block an SM on an H100's 132 SMs (scripts/routed_dw_sweep.py,
# PERF.md)
ROUTED_FLUSH = 2
ROUTED_SPLIT_GROUP = 33
ROUTED_SPLIT_PAIRS = 32768


def fused_builder_supported(n: int, m: int, k: int, d: int) -> bool:
    """The JAX package's shape gate, kept as it is so that both packages
    route the same shapes (``fused_builder.py:98-109``): K <= 16 (the max and
    min tie bits share one int32), D a multiple of 16 and at least 128, and
    ``ceil(N / 128) * D * 128 * 4`` bytes of resident g within 24 MiB, a
    limit of the TPU kernel's memory that this port keeps for parity."""
    if k > 16 or d % 16 != 0 or d < 128:
        return False
    c = -(-n // _LANES)
    resident = c * d * _LANES * 4
    return resident <= 24 * 2**20


def popcount16(v: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 16 bits of an int32 tensor."""
    v = v & 0xFFFF
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


class _SumSqF32(torch.autograd.Function):
    """Sum of squares over ``dims`` in f32 of a bf16 tensor, each square
    taken in f32 (exact for bf16 values), a slice of the leading axis at a
    time so that no f32 copy of the whole tensor exists; the gradient
    ``2 x g`` in x's type."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.save_for_backward(x)
        ctx.dims = dims
        step = max(1, (1 << 24) // max(1, x[0].numel()))
        parts = []
        for piece in x.split(step, dim=0):
            p32 = piece.to(torch.float32)
            parts.append((p32 * p32).sum(dim=dims, keepdim=True))
        out = parts[0]
        for part in parts[1:]:
            out = torch.cat([out, part]) if 0 not in dims else out + part
        return out.squeeze(dims)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        for d in sorted(ctx.dims):
            g = g.unsqueeze(d)
        return x * (2.0 * g).to(x.dtype), None


def sum_sq_f32(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``sum(x * x)`` over ``dims`` (which are non-negative) as an f32
    tensor, with every square in f32: XLA computes the JAX modules'
    ``jnp.sum(x * x, dtype=f32)`` of bf16 ``x`` so under ``jit`` (the
    product stays f32 inside the reduction's fusion), and the TPU builder
    kernel squares in f32 (``fused_builder.py:183-185``). f32 ``x`` takes the
    plain expression."""
    if x.dtype == torch.float32:
        return (x * x).sum(dim=dims)
    return _SumSqF32.apply(x, tuple(dims))


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def builder_core_plain(g: torch.Tensor, h: torch.Tensor, nn_idx: torch.Tensor):
    """Plain PyTorch version of kernel 5 (the JAX ``_core_xla``): g (B, N, D),
    h (B, M, D), nn_idx (B, M, K) -> (vmax, vmin, sg, bm, total, total_sq).

    ``x = where(hole, 0, g[nn]) - h`` in g's type; vmax/vmin over the live
    k; ``sg`` the f32 sum over k of the zero-holed gathered rows, in g's
    type; ``bm`` (B, M, D) int32 with bit k where the live x_k equals vmax
    and bit 16 + k where it equals vmin; f32 totals of x and of its f32
    squares over the live (m, k)."""
    K = nn_idx.shape[-1]
    hole = (nn_idx < 0)[..., None]  # (B, M, K, 1)
    gg = torch.where(hole, torch.zeros((), dtype=g.dtype, device=g.device),
                     gather_rows_padded(g, nn_idx))
    x = gg - h[:, :, None, :].to(g.dtype)
    vmax = torch.where(hole, -torch.inf, x).amax(dim=2)
    vmin = torch.where(hole, torch.inf, x).amin(dim=2)
    sg = gg.to(torch.float32).sum(dim=2).to(g.dtype)
    xz = torch.where(hole, torch.zeros((), dtype=x.dtype, device=x.device), x)
    total = xz.sum(dim=(0, 1, 2), dtype=torch.float32)
    total_sq = sum_sq_f32(xz, (0, 1, 2))
    live = ~hole
    bit = torch.arange(K, device=g.device)[None, None, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=g.device)
    bm = (torch.where(live & (x == vmax[:, :, None, :]), 1 << bit, zero)
          + torch.where(live & (x == vmin[:, :, None, :]), 1 << (16 + bit), zero)
          ).sum(dim=2)
    return vmax, vmin, sg, _to_int32(bm), total, total_sq


def routed_dw_plain(src: torch.Tensor, nn_idx: torch.Tensor, bm: torch.Tensor,
                    dvx: torch.Tensor, dvn: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 6 (the JAX ``_routed_dw_xla``):
    ``dW[c, d] = sum over (b, m, k) of src[nn, c] * w[b, m, k, d]`` with
    ``w = bit_k(bm) * dvx + bit_{16+k}(bm) * dvn``, f32 from the inputs'
    values, hole rows zero -> (Cin, D) f32. Materialises the (B, M, K, Cin)
    gather and the (B, M, K, D) weights."""
    K = nn_idx.shape[-1]
    f32 = torch.float32
    hole = (nn_idx < 0)[..., None]
    inpg = torch.where(hole, 0.0, gather_rows_padded(src, nn_idx).to(f32))
    bit = torch.arange(K, device=bm.device)[None, None, :, None]
    b = bm[:, :, None, :]
    w = (((b >> bit) & 1).to(f32) * dvx[:, :, None, :].to(f32)
         + ((b >> (16 + bit)) & 1).to(f32) * dvn[:, :, None, :].to(f32))
    Cin, D = src.shape[-1], bm.shape[-1]
    return inpg.reshape(-1, Cin).transpose(0, 1) @ w.reshape(-1, D)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_builder")
    if lib.pcm_builder_fwd.argtypes is None:
        lib.pcm_builder_fwd_partials.argtypes = [ctypes.c_int] * 3
        lib.pcm_builder_fwd_partials.restype = ctypes.c_longlong
        lib.pcm_builder_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.pcm_builder_fwd.restype = ctypes.c_int
        lib.pcm_routed_dw.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.pcm_routed_dw.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           dev: torch.device) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_nn(nn_idx: torch.Tensor, what: str) -> tuple[int, int, int]:
    if not nn_idx.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got nn_idx on {nn_idx.device}")
    if nn_idx.ndim != 3 or not 1 <= nn_idx.shape[2] <= _MAX_K:
        raise ValueError(f"{what} takes nn_idx (B, M, K) with 1 <= K <= {_MAX_K}, "
                         f"got {tuple(nn_idx.shape)}")
    B, M, K = nn_idx.shape
    _check("nn_idx", nn_idx, torch.int32, (B, M, K), nn_idx.device)
    return B, M, K


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def builder_core_cuda(g: torch.Tensor, h: torch.Tensor, nn_idx: torch.Tensor):
    """Kernel 5: contiguous bf16 g (B, N, D) and h (B, M, D), both 16-byte
    aligned, int32 nn_idx (B, M, K), K <= 16, D a multiple of 8, on one CUDA
    device -> (vmax, vmin, sg, bm, total, total_sq) as
    :func:`builder_core_plain` gives them."""
    global LAUNCHES
    if g.ndim != 3 or g.shape[2] % 8 or g.shape[2] < 8 or g.shape[1] < 1:
        raise ValueError(f"builder kernel takes g (B, N, D) with D a multiple of 8, got "
                         f"{tuple(g.shape)}")
    B, M, K = _check_nn(nn_idx, "builder kernel")
    dev = nn_idx.device
    if g.shape[0] != B:
        raise ValueError(f"builder kernel takes g (B, N, D) for nn_idx (B, M, K), got "
                         f"{tuple(g.shape)} and {tuple(nn_idx.shape)}")
    N, D = g.shape[1], g.shape[2]
    _check("g", g, torch.bfloat16, (B, N, D), dev)
    _check("h", h, torch.bfloat16, (B, M, D), dev)
    if g.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("builder kernel takes g and h 16-byte aligned")
    lib = _lib()
    out = [torch.empty((B, M, D), dtype=torch.bfloat16, device=dev) for _ in range(3)]
    bm = torch.empty((B, M, D), dtype=torch.int32, device=dev)
    totals = torch.empty((2, D), dtype=torch.float32, device=dev)
    part = torch.empty((lib.pcm_builder_fwd_partials(B, M, D), 2, D), dtype=torch.float32,
                       device=dev)
    err = lib.pcm_builder_fwd(g.data_ptr(), h.data_ptr(), nn_idx.data_ptr(),
                              *[t.data_ptr() for t in out], bm.data_ptr(),
                              part.data_ptr(), totals.data_ptr(), B, N, M, K, D,
                              dev.index, _stream(dev))
    _build.check(err, "builder_fwd")
    LAUNCHES += 1
    vmax, vmin, sg = out
    return vmax, vmin, sg, bm, totals[0], totals[1]


def pad_channels(src: torch.Tensor) -> torch.Tensor:
    """src (B, N, Cin) -> a zero-padded bf16 copy (B, N, Ci), Ci = Cin rounded
    up to a multiple of 16 (the JAX backward's ``Ci``,
    ``fused_builder.py:473-476``); ``[..., :Cin]`` of it is the bf16 source
    with rows 16-byte aligned, as kernel 6 reads them."""
    B, N, Cin = src.shape
    Ci = -(-Cin // 16) * 16
    out = torch.empty((B, N, Ci), dtype=torch.bfloat16, device=src.device)
    out[..., :Cin] = src
    out[..., Cin:] = 0
    return out


def routed_dw_splits(B: int, M: int) -> int:
    """Splits of kernel 6's B*M (b, m) pairs: ROUTED_SPLIT_GROUP for each
    ROUTED_SPLIT_PAIRS pairs begun, enough blocks to fill the card; a
    function of the shapes only, so the summation order is fixed."""
    return ROUTED_SPLIT_GROUP * -(-(B * M) // ROUTED_SPLIT_PAIRS)


def _pitched(src: torch.Tensor) -> bool:
    """Whether kernel 6 reads ``src`` (B, N, Cin) bf16 in place: unit
    channel stride, rows at a pitch of a multiple of 8 channels and 16-byte
    aligned, the clouds one after another, the storage holding every
    pitch."""
    B, N, Cin = src.shape
    pitch = src.stride(1)
    need = (src.storage_offset() + B * N * pitch) * src.element_size()
    return (src.stride(2) == 1 and pitch % 8 == 0 and pitch >= Cin
            and src.stride(0) == N * pitch and src.data_ptr() % 16 == 0
            and src.untyped_storage().nbytes() >= need)


def routed_dw_cuda(src: torch.Tensor, nn_idx: torch.Tensor, bm: torch.Tensor,
                   dvx: torch.Tensor, dvn: torch.Tensor, with_lo_share: bool = False):
    """Kernel 6: bf16 src (B, N, Cin) with rows at a pitch of a multiple of
    8 channels (a ``[..., :Cin]`` view of :func:`pad_channels`' copy, or a
    contiguous src with Cin a multiple of 8), contiguous int32 nn_idx (B, M,
    K), int32 bm and bf16 dvx, dvn (B, M, D), D a multiple of 8, the last
    three contiguous and 16-byte aligned, on one CUDA device -> (Cin, D)
    f32, as :func:`routed_dw_plain` computes it (up to summation order).
    With ``with_lo_share`` also the share of the kernel's (block, stage)
    tiles that ran the w_lo product (a 0-d f32 device tensor)."""
    global ROUTED_LAUNCHES
    B, M, K = _check_nn(nn_idx, "routed dW kernel")
    dev = nn_idx.device
    if src.ndim != 3 or src.shape[0] != B or bm.ndim != 3:
        raise ValueError(f"routed dW kernel takes src (B, N, Cin) and bm (B, M, D), "
                         f"got {tuple(src.shape)} and {tuple(bm.shape)}")
    N, Cin, D = src.shape[1], src.shape[2], bm.shape[2]
    if src.device != dev or src.dtype != torch.bfloat16:
        raise ValueError(f"src must be bf16 on {dev}, got {src.dtype} on {src.device}")
    if not _pitched(src):
        raise ValueError(f"routed dW kernel takes src rows 16-byte aligned at a pitch of a "
                         f"multiple of 8 channels (pad_channels' copy), got strides "
                         f"{src.stride()}")
    _check("bm", bm, torch.int32, (B, M, D), dev)
    _check("dvx", dvx, torch.bfloat16, (B, M, D), dev)
    _check("dvn", dvn, torch.bfloat16, (B, M, D), dev)
    if D % 8 or any(t.data_ptr() % 16 for t in (bm, dvx, dvn)):
        raise ValueError(f"routed dW kernel takes D a multiple of 8 and bm, dvx, dvn "
                         f"16-byte aligned, got D = {D}")
    splits = routed_dw_splits(B, M)
    part = torch.empty((splits, Cin, D), dtype=torch.float32, device=dev)
    out = torch.empty((Cin, D), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev) if with_lo_share else None
    err = _lib().pcm_routed_dw(src.data_ptr(), nn_idx.data_ptr(), bm.data_ptr(),
                               dvx.data_ptr(), dvn.data_ptr(), part.data_ptr(),
                               out.data_ptr(), None if counts is None else counts.data_ptr(),
                               B, N, M, K, Cin, src.stride(1), D, splits, dev.index,
                               _stream(dev))
    _build.check(err, "routed_dw")
    ROUTED_LAUNCHES += 1
    if not with_lo_share:
        return out
    return out, counts[0].float() / counts[1].clamp_min(1).float()


def _builder_bwd(src, W, h, nn_idx, g, sg, bm, dvmax, dvmin, dtot, dts):
    """The JAX ``_builder_bwd_impl``: -> (dW (Cin, D) in W's type, dh in
    h's type)."""
    f32 = torch.float32
    B, M, K = nn_idx.shape
    N, Cin = src.shape[1], src.shape[2]
    D = W.shape[1]
    hole = nn_idx < 0
    kv = (~hole).sum(dim=-1).to(f32)[..., None]  # (B, M, 1)
    has = (kv > 0).to(f32)
    cnt_max = torch.clamp_min(popcount16(bm), 1).to(f32)
    cnt_min = torch.clamp_min(popcount16(bm >> 16), 1).to(f32)
    dvx = dvmax.to(f32) / cnt_max
    dvn = dvmin.to(f32) / cnt_min
    srcp = pad_channels(src)  # (B, N, Ci) bf16, Ci a multiple of 16
    Ci = srcp.shape[2]

    # (1) routed term
    routed = routed_dw_plain if src.device.type == "cpu" else routed_dw_cuda
    dw_routed = routed(srcp[..., :Cin], nn_idx, bm, dvx.to(torch.bfloat16),
                       dvn.to(torch.bfloat16))

    # (2) multiplicity-weighted g term
    off = (torch.arange(B, device=src.device) * N)[:, None, None]
    rows = (torch.where(hole, 0, nn_idx).to(torch.long) + off).reshape(-1)
    r = torch.zeros(B * N, dtype=f32, device=src.device).index_add_(
        0, rows, (~hole).to(f32).reshape(-1)).reshape(B, N, 1)
    dw_g = 2.0 * ((r * src.to(f32)).reshape(-1, Cin).transpose(0, 1)
                  @ g.to(f32).reshape(-1, D)) * dts[None, :]

    # (3) h term, s_m = sum_k src[nn[m, k]] (one neighbour at a time: the
    # (B, M, K, Cin) gather never exists)
    s = torch.zeros((B, M, Ci), dtype=f32, device=src.device)
    for k in range(K):
        s += torch.where(hole[:, :, k, None], 0.0,
                         gather_rows_padded(srcp, nn_idx[:, :, k]).to(f32))
    s = s[..., :Cin]
    dw_h = -2.0 * (s.reshape(-1, Cin).transpose(0, 1)
                   @ h.to(f32).reshape(-1, D)) * dts[None, :]

    # (4) d_total term
    dw_tot = s.sum(dim=(0, 1))[:, None] * dtot[None, :]

    dh = -(has * (dvmax.to(f32) + dvmin.to(f32)) + kv * dtot
           + 2.0 * dts * (sg.to(f32) - kv * h.to(f32)))
    dW = dw_routed + dw_g + dw_h + dw_tot
    return dW.to(W.dtype), dh.to(h.dtype)


class _GroupedStatsData(torch.autograd.Function):
    """Forward by kernel 5 (plain version for CPU tensors); backward by
    :func:`_builder_bwd` with kernel 6. The ``src`` cotangent is zero."""

    @staticmethod
    def forward(ctx, src, W, h, nn_idx):
        g = src @ W  # (B, N, D)
        core = builder_core_plain if g.device.type == "cpu" else builder_core_cuda
        vmax, vmin, sg, bm, total, total_sq = core(g, h, nn_idx)
        ctx.save_for_backward(src, W, h, nn_idx, g, sg, bm)
        return vmax, vmin, total, total_sq

    @staticmethod
    def backward(ctx, dvmax, dvmin, dtot, dts):
        src, W, h, nn_idx, g, sg, bm = ctx.saved_tensors
        dW, dh = _builder_bwd(src, W, h, nn_idx, g, sg, bm, dvmax, dvmin,
                              dtot.to(torch.float32), dts.to(torch.float32))
        return None, dW, dh, None


def grouped_stats_data(src: torch.Tensor, W: torch.Tensor, h: torch.Tensor,
                       nn_idx: torch.Tensor):
    """Token-builder statistics with the scatter-free backward.

    src (B, N, Cin), W (Cin, D), h (B, M, D), nn_idx (B, M, K) int32 (-1 =
    hole) -> (vmax (B, M, D), vmin (B, M, D), total (D,) f32, total_sq (D,)
    f32) of ``x = (src @ W)[nn] - h``. ``src`` gets no gradient (callers
    pass data, detached); ``W`` gets the factorised dW and ``h`` its
    closed-form cotangent. On the card the forward kernel takes bf16 only.
    """
    return _GroupedStatsData.apply(src, W, h, nn_idx)
