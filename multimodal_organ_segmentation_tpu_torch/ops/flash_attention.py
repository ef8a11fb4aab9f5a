"""Flash attention over voxel tokens: kernel B.

Port of the JAX package's ``ops/pallas/flash_attention.py``: non-causal
attention forward over ``[B, N, H, D]`` query/key/value, no bias, query and
key lengths may differ. ``flash_attention`` launches the hand-written CUDA
kernel (``csrc/flash_attention.cu``) on a CUDA tensor; on a CPU tensor it
runs the kernel's plain version, ``ops.attention.blockwise_attention`` with
the Pallas kernel's 512-key blocks. It is a ``torch.autograd.Function`` (the
JAX kernel is a ``custom_vjp``): the backward differentiates the plain
version on the saved inputs.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_organ_segmentation_tpu_torch.ops import _build

MAX_HEAD_DIM = 256  # q, K and V tiles of 64 rows fit in shared memory up to here
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": (
        _I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    )
}


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
    """Check the inputs, launch kernel B, count the launch."""
    _check_inputs(q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, k.shape[1], h, d,
        d**-0.5, _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel B on a CUDA tensor, the plain version on a CPU tensor.
    Backward: the gradient of ``blockwise_attention`` re-run on the saved q,
    k, v (no probabilities are kept), as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return _plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = _plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash multi-head attention over ``[B, N, H, D]`` tokens,
    differentiable in q, k and v.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises on anything the kernel does not take. Either way the result
    stays in the autograd graph: the backward is the gradient of the plain
    version on the saved inputs.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
