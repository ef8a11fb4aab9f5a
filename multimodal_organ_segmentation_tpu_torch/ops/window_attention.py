"""Windowed multi-head attention: kernel A and its plain PyTorch version.

Port of the JAX package's ``ops/pallas/window_attention.py``. For windows
``[BW, N, H, D]`` (BW = batch * num_windows, windows fastest, as
``window_partition`` orders them)::

    out = softmax(q . k^T * D**-0.5 + bias[h] + mask[bw % num_windows]) . v

with the math in f32 and the output in q's dtype. ``window_mha`` launches the
hand-written CUDA kernel (``csrc/window_attention.cu``) on a CUDA tensor and
runs ``dense_window_mha`` on a CPU tensor. It is a ``torch.autograd.Function``
(the JAX kernel is a ``custom_vjp``): the backward differentiates the plain
version on the saved inputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from multimodal_organ_segmentation_tpu_torch.ops import _build

MAX_TOKENS = 512  # the kernel keeps at most 16 keys per lane in registers
HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56, 64)  # the head dims the kernel is built for
SMEM_LIMIT = 227 * 1024  # shared memory one block can use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_SIGNATURES = {
    "window_mha_fwd": (
        ctypes.c_int,
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    )
}


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
    if 2 * n * (d + 4) * 4 > SMEM_LIMIT:
        raise ValueError(f"window_mha: K and V of a window ({n} tokens, head dim {d}) do not fit "
                         "in shared memory")
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


def _launch(q, k, v, bias, mask, num_windows) -> torch.Tensor:
    """Check the inputs, launch kernel A, count the launch."""
    if mask is None:
        num_windows = 1
    _check_inputs(q, k, v, bias, mask, num_windows)
    bw, n, h, d = q.shape
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("window_attention", _SIGNATURES)
    err = lib.window_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
        bias.data_ptr(), mask.data_ptr() if mask is not None else None, out.data_ptr(),
        bw, n, h, d, num_windows, d**-0.5, _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "window_mha")
    window_mha.launches += 1
    return out


class _WindowMHA(torch.autograd.Function):
    """Forward: kernel A on a CUDA tensor, the plain version on a CPU tensor.
    Backward: the gradient of the plain version on the saved inputs (q, k,
    v, bias, mask; no probabilities are kept), as the JAX package's
    ``custom_vjp`` takes ``jax.vjp`` of its dense form. ``mask`` gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_windows):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.num_windows = num_windows
        if q.device.type == "cpu":
            return dense_window_mha(q, k, v, bias, mask, num_windows)
        return _launch(q, k, v, bias, mask, num_windows)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias, mask = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v, bias), ctx.needs_input_grad[:4])]
        with torch.enable_grad():
            out = dense_window_mha(*inputs, mask, ctx.num_windows)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


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

    A CPU tensor runs :func:`dense_window_mha`; a CUDA tensor launches the
    kernel or raises on anything the kernel does not take. Either way the
    result stays in the autograd graph: the backward is the gradient of
    :func:`dense_window_mha` on the saved inputs.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_mha: unsupported device {q.device}")
    return _WindowMHA.apply(q, k, v, bias, mask, num_windows)


window_mha.launches = 0
