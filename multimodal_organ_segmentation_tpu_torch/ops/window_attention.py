"""Windowed multi-head attention: kernel A and its plain PyTorch version.

Port of the JAX package's ``ops/pallas/window_attention.py``. For windows
``[BW, N, H, D]`` (BW = batch * num_windows, windows fastest, as
``window_partition`` orders them)::

    out = softmax(q . k^T * D**-0.5 + bias[h] + mask[bw % num_windows]) . v

with the math in f32 and the output in q's dtype. ``window_mha`` launches the
hand-written CUDA kernel (``csrc/window_attention.cu``) on a CUDA tensor and
runs ``dense_window_mha`` on a CPU tensor. It is the ``torch.library`` custom
op ``organseg_torch::window_mha``, so ``torch.export`` keeps it as one node of
an exported program; its gradient (the JAX kernel is a ``custom_vjp``),
registered with ``register_autograd``, differentiates the plain version on
the saved inputs.

The kernel has three routes, and :func:`plan` picks one by this rule: bf16
with a head dim in ``MMA_HEAD_DIMS``, q, k, v starting on 16-byte
boundaries with window and token strides that are multiples of 8 elements
takes a tensor-core route: ``"wgmma"`` (Hopper's warpgroup products fed by
TMA) for windows of up to ``WGMMA_MAX_TOKENS`` tokens where its ring fits
shared memory, else ``"mma"`` (mma.sync) where that plan fits; the rest
(float32, other head dims or alignments) takes ``"f32"`` (the f32 pipes).
``window_mha.launches`` counts the launches of each route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from multimodal_organ_segmentation_tpu_torch.ops import _build

MAX_TOKENS = 512  # the f32 route keeps at most 16 keys per lane in registers
HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56, 64)  # the head dims the kernel is built for
MMA_HEAD_DIMS = (16, 32, 48, 64)  # the tensor-core route: whole k16 steps
WGMMA_MAX_TOKENS = 256  # the wgmma route keeps a whole row of scores in accumulators
WGMMA_KEY_TILES = (8, 16, 27, 32)  # its builds: score columns in n8 tiles (64, 128, 216, 256)
WGMMA_MAX_STAGES = 3
WGMMA_THREADS = 384  # two consumer warpgroups and the producer warpgroup
WGMMA_MAX_WALK = 64  # tiles one block of the wgmma route walks at most
WGMMA_STAGING = 2  # a wgmma block's staging of its bias, in tile times (H100, N = 216)
ROUTES = ("wgmma", "mma", "f32")
SMEM_LIMIT = 232_448  # dynamic shared memory one block can use on Hopper (227 KB)
SM_COUNT = 132  # H100 SXM; a plan for another card passes its own
MAX_WALK = 16  # tiles one block of the mma route walks at most
MAX_WARPS = 8  # warps (of 16 query rows) in one block of the mma route
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "window_mha_fwd": (
        _I, [_P, _P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    ),
    "window_mha_fwd_mma": (
        _I, [_P, _P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P],
    ),
    "window_mha_fwd_wgmma": (
        _I, [_P, _P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
             _P],
    ),
}


def _mma_smem(rows: int, kpad: int, d: int) -> int:
    """The mma route's shared memory: its rows of bias + mask in fp16
    (stride kpad + 8), then two buffers of Q rows, K and V in bf16, rows
    padded to D + 8."""
    return 2 * rows * (kpad + 8) + 2 * 2 * (rows + 2 * kpad) * (d + 8)


def wgmma_layout(n: int, d: int) -> dict:
    """The wgmma route's shapes for windows of n tokens at head dim d, as
    ``csrc/window_attention.cu::wgmma_layout``: ``key_tiles`` (score columns
    in n8 tiles, the build that covers n), ``kpad`` (K and V rows, whole k16
    steps of P.V), ``qpad`` (Q rows, whole 64-row tiles), the staged bias's
    bytes (``kpad`` rows of fp16, the row stride 8 mod 16 elements, rounded
    up to 128 bytes) and one ring stage's bytes (Q, K, V in bf16)."""
    nt8 = next(t for t in WGMMA_KEY_TILES if 8 * t >= n)
    kpad = 16 * math.ceil(nt8 / 2)
    qpad = 64 * math.ceil(n / 64)
    stride = 8 * nt8 + (0 if nt8 % 2 else 8)
    return dict(key_tiles=nt8, kpad=kpad, qpad=qpad,
                bias_bytes=math.ceil(2 * kpad * stride / 128) * 128,
                stage_bytes=(qpad + 2 * kpad) * d * 2)


def wgmma_smem(n: int, d: int, stages: int) -> int:
    """Shared memory of the wgmma route: the staged bias, ``stages`` ring
    stages, the mbarriers of three stages and 128 bytes to align the base."""
    lay = wgmma_layout(n, d)
    return lay["bias_bytes"] + stages * lay["stage_bytes"] + 8 * 2 * WGMMA_MAX_STAGES + 128


@functools.lru_cache(maxsize=None)
def wgmma_walk(batch: int, blocks: int, sm_count: int) -> int:
    """Tiles one block of the wgmma route walks. One block fills an SM
    (its shared memory and all 64K registers), so the grid runs in waves of
    ``sm_count`` blocks and takes about waves x (tiles + ``WGMMA_STAGING``)
    tile times, the last term a block's staging of its bias and the filling
    of its ring. The walk of at most ``WGMMA_MAX_WALK`` tiles, cut into
    equal groups, that takes the least (the shorter walk on a tie)."""
    best = None
    for t in range(1, min(batch, WGMMA_MAX_WALK) + 1):
        groups = math.ceil(batch / t)
        tiles = math.ceil(batch / groups)
        cost = math.ceil(blocks * groups / sm_count) * (tiles + WGMMA_STAGING)
        if best is None or cost < best[0]:
            best = (cost, tiles)
    return best[1]


def plan(bw: int, n: int, heads: int, d: int, num_windows: int, dtype: torch.dtype,
         aligned: bool = True, sm_count: int = SM_COUNT, route: Optional[str] = None) -> dict:
    """The route and launch plan of kernel A for one call: ``route``,
    ``grid`` (x, y), ``threads`` a block, ``rows`` (query rows a block),
    ``tiles_per_block`` (tiles b a block walks), ``smem`` (dynamic
    shared-memory bytes) and, for wgmma, ``stages`` (the ring's).
    ``aligned``: q, k, v start on 16-byte boundaries and their window and
    token strides are multiples of 8 elements. ``route`` forces a route (a
    check that times one route against another); it raises where that
    route does not take the call.

    Routes: bf16 at a head dim of ``MMA_HEAD_DIMS`` with aligned inputs
    takes wgmma where N <= ``WGMMA_MAX_TOKENS`` and at least one ring stage
    fits beside the staged bias, and mma otherwise (N = 343 and 512, the
    ``monai_compat`` and 8³ windows, and the widest heads at N near 256);
    the rest takes f32.

    wgmma: block x = (head, window), head fastest; block y = group of tiles
    (``wgmma_walk``). One block covers all of a window's rows: 64-row
    tiles, two consumer warpgroups taking them in turn. mma and f32: see
    :func:`mma_plan` and :func:`f32_plan`."""
    tensor_cores = dtype == torch.bfloat16 and d in MMA_HEAD_DIMS and aligned
    found = None
    if tensor_cores and n <= WGMMA_MAX_TOKENS and route in (None, "wgmma"):
        free = SMEM_LIMIT - wgmma_smem(n, d, 0)
        stages = min(WGMMA_MAX_STAGES, free // wgmma_layout(n, d)["stage_bytes"])
        if stages >= 1:
            batch, blocks = bw // num_windows, heads * num_windows
            tiles = wgmma_walk(batch, blocks, sm_count)
            found = dict(route="wgmma", grid=(blocks, math.ceil(batch / tiles)),
                         threads=WGMMA_THREADS, rows=wgmma_layout(n, d)["qpad"],
                         tiles_per_block=tiles, stages=stages, smem=wgmma_smem(n, d, stages))
    if found is None and tensor_cores and route in (None, "mma"):
        found = mma_plan(bw, n, heads, d, num_windows, sm_count)
    if found is None and route in (None, "f32"):
        found = f32_plan(bw, n, heads, d)
    if found is None:
        raise ValueError(f"window_mha: route {route!r} does not take N={n}, head dim {d}, "
                         f"{dtype} (aligned: {aligned})")
    return found


def mma_plan(bw: int, n: int, heads: int, d: int, num_windows: int,
             sm_count: int = SM_COUNT) -> Optional[dict]:
    """The mma route's plan, or None where no row block fits shared memory.
    Block x = (row block, head, window), row block fastest and window
    slowest; block y = group of tiles. Rows a block: 16 a warp, the fewest
    row blocks of at most ``MAX_WARPS`` warps that cover N and fit shared
    memory. Tiles a block: all of the batch up to ``MAX_WALK``, fewer where
    the grid would otherwise give an SM fewer than two blocks."""
    batch = bw // num_windows
    kpad = math.ceil(n / 16) * 16
    m_tiles = kpad // 16
    for row_blocks in range(math.ceil(m_tiles / MAX_WARPS), m_tiles + 1):
        warps = math.ceil(m_tiles / row_blocks)
        smem = _mma_smem(16 * warps, kpad, d)
        if smem <= SMEM_LIMIT:
            blocks = row_blocks * heads * num_windows
            groups = min(batch, max(math.ceil(batch / MAX_WALK),
                                    math.ceil(2 * sm_count / blocks)))
            tiles = batch // groups
            return dict(route="mma", grid=(blocks, math.ceil(batch / tiles)),
                        threads=32 * warps, rows=16 * warps, tiles_per_block=tiles, smem=smem)
    return None


def f32_plan(bw: int, n: int, heads: int, d: int) -> dict:
    """The f32 route's plan: one block of 8 warps per (window, head), every
    row."""
    return dict(route="f32", grid=(bw * heads, 1), threads=256, rows=n, tiles_per_block=1,
                smem=2 * n * (d + 4) * 4)


def dense_window_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_windows: int,
) -> torch.Tensor:
    """Plain version of kernel A (the reference dense formula)."""
    bw, n, h, d = q.shape
    scale = d**-0.5
    acc = torch.promote_types(q.dtype, torch.float32)  # f32 math; f64 stays f64
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc)) * scale
    s = s + bias[None].to(acc)
    if mask is not None:
        s = s + mask.to(acc).repeat(bw // num_windows, 1, 1)[:, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p, v.to(acc))
    return out.to(q.dtype)


def _check_inputs(q, k, v, bias, mask, num_windows) -> None:
    if q.dim() != 4:
        raise ValueError(f"window_mha: q must be [BW, N, H, D], got {tuple(q.shape)}")
    bw, n, h, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"window_mha: q, k, v must share a float32 or bfloat16 dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("window_mha: q, k and v must have the same shape")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(3) != 1 or q.stride(2) != d:
        raise ValueError("window_mha: q, k, v must share strides with heads and head dim contiguous")
    if not 0 < n <= MAX_TOKENS:
        raise ValueError(f"window_mha: the kernel takes 1..{MAX_TOKENS} tokens per window, got {n}")
    if d not in HEAD_DIMS:
        raise ValueError(f"window_mha: the kernel takes head dims {HEAD_DIMS}, got {d}")
    if bias.dtype != torch.float32 or bias.shape != (h, n, n) or not bias.is_contiguous():
        raise ValueError(f"window_mha: bias must be contiguous f32 [{h}, {n}, {n}]")
    if mask is not None:
        if mask.dtype != torch.float32 or mask.shape != (num_windows, n, n) or not mask.is_contiguous():
            raise ValueError(f"window_mha: mask must be contiguous f32 [{num_windows}, {n}, {n}]")
    if num_windows < 1 or bw % num_windows:
        raise ValueError(f"window_mha: {bw} windows are not a multiple of num_windows={num_windows}")
    tensors = [q, k, v, bias] + ([mask] if mask is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("window_mha: all inputs must be on one device")


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    return (all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and q.stride(0) % 8 == 0 and q.stride(1) % 8 == 0)


def _launch(q, k, v, bias, mask, num_windows, route: Optional[str] = None) -> torch.Tensor:
    """Check the inputs, launch kernel A on the route :func:`plan` picks
    (or ``route``), count the launch."""
    if mask is None:
        num_windows = 1
    _check_inputs(q, k, v, bias, mask, num_windows)
    bw, n, h, d = q.shape
    p = plan(bw, n, h, d, num_windows, q.dtype, _aligned(q, k, v), _sm_count(q.device.index),
             route)
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"window_mha: K and V of a window ({n} tokens, head dim {d}) do not fit "
                         "in shared memory")
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("window_attention", _SIGNATURES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
            bias.data_ptr(), mask.data_ptr() if mask is not None else None, out.data_ptr(),
            bw, n, h, d, num_windows)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch = (*p["grid"], p["smem"], q.device.index, stream)
    if p["route"] == "wgmma":
        err = lib.window_mha_fwd_wgmma(*args, d**-0.5 * math.log2(math.e), p["tiles_per_block"],
                                       p["stages"], *p["grid"], p["threads"], p["smem"],
                                       q.device.index, stream)
    elif p["route"] == "mma":
        err = lib.window_mha_fwd_mma(*args, d**-0.5 * math.log2(math.e), p["threads"] // 32,
                                     p["tiles_per_block"], *launch)
    else:
        err = lib.window_mha_fwd(*args, d**-0.5, _DTYPES[q.dtype], *launch)
    _build.check(lib, err, f"window_mha ({p['route']} route)")
    window_mha.launches[p["route"]] += 1
    return out


@torch.library.custom_op("organseg_torch::window_mha", mutates_args=())
def _window_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor], num_windows: int) -> torch.Tensor:
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return dense_window_mha(q, k, v, bias, mask, num_windows)
    return _launch(q, k, v, bias, mask, num_windows)


@_window_mha_op.register_fake
def _(q, k, v, bias, mask, num_windows):
    return q.new_empty(q.shape)  # contiguous, as the kernel writes it


def _setup_context(ctx, inputs, output):
    q, k, v, bias, mask, num_windows = inputs
    ctx.save_for_backward(q, k, v, bias, mask)
    ctx.num_windows = num_windows


def _backward(ctx, grad_out):
    """The gradient of the plain version on the saved inputs (q, k, v, bias,
    mask; no probabilities are kept), as the JAX package's ``custom_vjp``
    takes ``jax.vjp`` of its dense form. ``mask`` gets none."""
    q, k, v, bias, mask = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip((q, k, v, bias), ctx.needs_input_grad[:4])]
    with torch.enable_grad():
        out = dense_window_mha(*inputs, mask, ctx.num_windows)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


_window_mha_op.register_autograd(_backward, setup_context=_setup_context)


def window_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_windows: int,
) -> torch.Tensor:
    """Fused windowed MHA, differentiable in q, k, v and bias.

    Args:
        q, k, v: ``[BW, N, H, D]`` with BW = batch * num_windows, windows
            fastest. On CUDA they may be strided views (e.g. slices of one
            qkv projection) as long as they share strides and each token's
            ``H * D`` values are contiguous.
        bias: relative position bias ``[H, N, N]``, f32.
        mask: shift mask ``[num_windows, N, N]``, f32, or None.
        num_windows: nW, for the mask index ``bw % nW``.
    Returns:
        ``[BW, N, H, D]`` in q's dtype.

    The custom op ``torch.ops.organseg_torch.window_mha``: a CPU tensor runs
    :func:`dense_window_mha`; a CUDA tensor launches the kernel or raises on
    anything the kernel does not take. Either way the result stays in the
    autograd graph (the backward is the gradient of :func:`dense_window_mha`
    on the saved inputs), and ``torch.export`` keeps the op as one node
    whose fake version gives the shape for any tile batch.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_mha: unsupported device {q.device}")
    return _window_mha_op(q, k, v, bias, mask, num_windows)


window_mha.launches = dict.fromkeys(ROUTES, 0)
