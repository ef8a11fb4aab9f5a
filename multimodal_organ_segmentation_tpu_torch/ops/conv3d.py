"""SAME 3x3x3 convolution, channels-last: kernel C and its plain version.

Port of the JAX package's ``scripts/proto_conv_kernel.py::conv3x3x3_pallas``:
``x [B, D, H, W, C] . w [3, 3, 3, C, Cout] -> [B, D, H, W, Cout]``, stride 1,
zero padding, no bias, f32 accumulation, output in x's dtype. ``conv3x3x3``
launches the hand-written CUDA kernel (``csrc/conv3x3x3.cu``) on a CUDA
tensor and runs ``conv3x3x3_plain`` on a CPU tensor. Like the JAX kernel it
is forward only (no gradient is defined) and no model calls it: it has its
own entry point, ``scripts/proto_conv_kernel_torch.py``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multimodal_organ_segmentation_tpu_torch.ops import _build

CHANNEL_MULTIPLE = 8  # one 16-byte load of bf16 channels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"conv3x3x3_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])}


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: the 27 shifted ``[..., C] . [C, Cout]``
    products of the zero-padded input, summed in f32 tap by tap (f64 stays
    f64), then rounded to x's dtype."""
    _check_shapes(x, w)
    b, d, h, wd, _ = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, wd, w.shape[-1]), dtype=acc_dtype, device=x.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, :].to(acc_dtype)
                acc += tap @ w[kd, kh, kw].to(acc_dtype)
    return acc.to(x.dtype)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"conv3x3x3: x must be [B, D, H, W, C], got {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"conv3x3x3: w must be [3, 3, 3, {x.shape[-1]}, Cout], got "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"conv3x3x3: x and w must share a dtype, got {x.dtype} and {w.dtype}")


def _check_kernel_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    _check_shapes(x, w)
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3x3: the kernel takes float32 or bfloat16, got {x.dtype}")
    c, cout = w.shape[3], w.shape[4]
    if c % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE or min(x.shape) < 1:
        raise ValueError(f"conv3x3x3: the kernel takes non-empty inputs with C and Cout "
                         f"multiples of {CHANNEL_MULTIPLE}, got C={c}, Cout={cout}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("conv3x3x3: x must be contiguous and 16-byte aligned")
    if w.device != x.device:
        raise ValueError("conv3x3x3: x and w must be on one device")
    if x.requires_grad or w.requires_grad:
        raise RuntimeError("conv3x3x3: the kernel is forward only (no gradient is defined)")


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3x3 convolution of channels-last ``x`` with ``w [3,3,3,C,Cout]``.

    A CPU tensor runs :func:`conv3x3x3_plain`; a CUDA tensor launches the
    kernel or raises on anything the kernel does not take (C and Cout must
    be multiples of 8; any D, H, W).
    """
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3: unsupported device {x.device}")
    _check_kernel_inputs(x, w)
    b, d, h, wd, c = x.shape
    cout = w.shape[-1]
    # tap-major [27, Cout, C]: a k-pair of one output channel is one 32-bit load
    wt = w.detach().reshape(27, c, cout).transpose(1, 2).contiguous()
    out = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3x3x3", _SIGNATURES)
    err = lib.conv3x3x3_fwd(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, d, h, wd, c, cout,
        _DTYPES[x.dtype], x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "conv3x3x3")
    conv3x3x3.launches += 1
    return out


conv3x3x3.launches = 0
