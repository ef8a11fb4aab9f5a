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

The kernel has two routes, and :func:`plan` picks one by this rule: bf16
with a head dim in ``MMA_HEAD_DIMS``, q, k, v starting on 16-byte
boundaries with window and token strides that are multiples of 8 elements,
and a plan that fits shared memory, takes ``"mma"`` (tensor cores); the rest
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
ROUTES = ("mma", "f32")
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
}


def _mma_smem(rows: int, kpad: int, d: int) -> int:
    """The mma route's shared memory: its rows of bias + mask in fp16
    (stride kpad + 8), then two buffers of Q rows, K and V in bf16, rows
    padded to D + 8."""
    return 2 * rows * (kpad + 8) + 2 * 2 * (rows + 2 * kpad) * (d + 8)


def plan(bw: int, n: int, heads: int, d: int, num_windows: int, dtype: torch.dtype,
         aligned: bool = True, sm_count: int = SM_COUNT) -> dict:
    """The route and launch plan of kernel A for one call: ``route``,
    ``grid`` (x, y), ``threads`` a block, ``rows`` (query rows a block),
    ``tiles_per_block`` (tiles b a block walks) and ``smem`` (dynamic
    shared-memory bytes).
    ``aligned``: q, k, v start on 16-byte boundaries and their window and
    token strides are multiples of 8 elements.

    mma: block x = (row block, head, window), row block fastest and window
    slowest; block y = group of tiles. Rows a block: 16 a warp, the fewest
    row blocks of at most ``MAX_WARPS`` warps that cover N and fit shared
    memory. Tiles a block: all of the batch up to ``MAX_WALK``, fewer where
    the grid would otherwise give an SM fewer than two blocks. f32: one
    block of 8 warps per (window, head), every row."""
    batch = bw // num_windows
    if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS and aligned:
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
                            threads=32 * warps, rows=16 * warps, tiles_per_block=tiles,
                            smem=smem)
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


def _launch(q, k, v, bias, mask, num_windows) -> torch.Tensor:
    """Check the inputs, launch kernel A on the route :func:`plan` picks,
    count the launch."""
    if mask is None:
        num_windows = 1
    _check_inputs(q, k, v, bias, mask, num_windows)
    bw, n, h, d = q.shape
    p = plan(bw, n, h, d, num_windows, q.dtype, _aligned(q, k, v), _sm_count(q.device.index))
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"window_mha: K and V of a window ({n} tokens, head dim {d}) do not fit "
                         "in shared memory")
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("window_attention", _SIGNATURES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
            bias.data_ptr(), mask.data_ptr() if mask is not None else None, out.data_ptr(),
            bw, n, h, d, num_windows)
    launch = (*p["grid"], p["smem"], q.device.index,
              torch.cuda.current_stream(q.device).cuda_stream)
    if p["route"] == "mma":
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
