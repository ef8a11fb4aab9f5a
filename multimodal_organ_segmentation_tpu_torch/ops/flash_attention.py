"""Flash attention over voxel tokens: kernel B.

Port of the JAX package's ``ops/pallas/flash_attention.py``: non-causal
attention forward over ``[B, N, H, D]`` query/key/value, no bias, query and
key lengths may differ. ``flash_attention`` launches the hand-written CUDA
kernel (``csrc/flash_attention.cu``) on a CUDA tensor; on a CPU tensor it
runs the kernel's plain version, ``ops.attention.blockwise_attention`` with
the Pallas kernel's 512-key blocks. It is the ``torch.library`` custom op
``organseg_torch::flash_attention``, so ``torch.export`` keeps it as one node
of an exported program; its gradient (the JAX kernel is a ``custom_vjp``),
registered with ``register_autograd``, differentiates the plain version on
the saved inputs.

The kernel has two routes, and :func:`plan` picks one by this rule: bf16
with a head dim that is a multiple of 16 up to 128 and 16-byte aligned
q, k, v takes ``"mma"`` (tensor cores); everything else (float32, other
head dims) takes ``"f32"`` (the f32 pipes). ``flash_attention.launches``
counts the launches of each route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from multimodal_organ_segmentation_tpu_torch.ops import _build

MAX_HEAD_DIM = 256  # q, K and V tiles of 64 rows fit in shared memory up to here
MMA_MAX_HEAD_DIM = 128  # the tensor-core route: D a multiple of 16 up to here
ROUTES = ("mma", "f32")
SMEM_LIMIT = 232_448  # dynamic shared memory one block can use on Hopper (227 KB)
MAX_GRID_Y = 65_535
BLOCK_Q = 64  # query rows a block, both routes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P]),
    "flash_attention_fwd_mma": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
}


def plan(b: int, nq: int, nk: int, heads: int, d: int, dtype: torch.dtype,
         aligned: bool = True) -> dict:
    """The route and launch plan of kernel B for one call: ``route``,
    ``grid`` (x, y), ``threads`` a block, ``rows`` (query rows a block) and
    ``smem`` (dynamic shared-memory bytes). ``aligned``: q, k and v start on
    16-byte boundaries (the tensor-core route copies 16-byte pieces).

    mma: grid (query blocks, B*H), 4 warps of 16 query rows, K and V
    [2][64][D+8] bf16 (the Q tile passes through the second buffer). f32:
    grid (B*H, query blocks), 8 warps, the f32 tiles of
    ``csrc/flash_attention.cu::smem_bytes``."""
    q_blocks = math.ceil(nq / BLOCK_Q)
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= MMA_MAX_HEAD_DIM and aligned:
        p = dict(route="mma", grid=(q_blocks, b * heads), threads=128,
                 smem=4 * 64 * (d + 8) * 2)
    else:
        p = dict(route="f32", grid=(b * heads, q_blocks), threads=256,
                 smem=(BLOCK_Q * d + 64 * (d + 4) + 64 * d + 8 * 64 * 8) * 4)
    p["rows"] = BLOCK_Q
    if p["grid"][1] > MAX_GRID_Y:
        raise ValueError(f"flash_attention: grid {p['grid']} is too large")
    return p


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, N, H, D]")
    b, _, h, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a float32 or bfloat16 dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys")
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"flash_attention: the kernel takes head dims that are multiples of 4 "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all inputs must be on one device")


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    from multimodal_organ_segmentation_tpu_torch.ops.attention import blockwise_attention

    return blockwise_attention(q, k, v, kv_block=512)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Check the inputs, launch kernel B on the route :func:`plan` picks,
    count the launch."""
    _check_inputs(q, k, v)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    p = plan(b, nq, nk, h, d, q.dtype, aligned)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    launch = (*p["grid"], p["smem"], q.device.index, stream)
    if p["route"] == "mma":
        err = lib.flash_attention_fwd_mma(*ptrs, b, nq, nk, h, d, d**-0.5 * math.log2(math.e),
                                          *launch)
    else:
        err = lib.flash_attention_fwd(*ptrs, b, nq, nk, h, d, d**-0.5, _DTYPES[q.dtype], *launch)
    _build.check(lib, err, f"flash_attention ({p['route']} route)")
    flash_attention.launches[p["route"]] += 1
    return out


@torch.library.custom_op("organseg_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return _plain(q, k, v)
    return _launch(q, k, v)


@_flash_attention_op.register_fake
def _(q, k, v):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad_out):
    """The gradient of ``blockwise_attention`` re-run on the saved q, k, v
    (no probabilities are kept), as the JAX package's ``custom_vjp``."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = _plain(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


_flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash multi-head attention over ``[B, N, H, D]`` tokens,
    differentiable in q, k and v.

    The custom op ``torch.ops.organseg_torch.flash_attention``: a CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises on
    anything the kernel does not take. Either way the result stays in the
    autograd graph (the backward is the gradient of the plain version on the
    saved inputs), and ``torch.export`` keeps the op as one node.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_attention_op(q, k, v)


flash_attention.launches = dict.fromkeys(ROUTES, 0)
