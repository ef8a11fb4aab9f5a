"""SAME 3x3x3 convolution, channels-last: kernel C and its plain version.

Port of the JAX package's ``scripts/proto_conv_kernel.py::conv3x3x3_pallas``:
``x [B, D, H, W, C] . w [3, 3, 3, C, Cout] -> [B, D, H, W, Cout]``, stride 1,
zero padding, no bias, f32 accumulation, output in x's dtype. ``conv3x3x3``
launches the hand-written CUDA kernel (``csrc/conv3x3x3.cu``) on a CUDA
tensor and runs ``conv3x3x3_plain`` on a CPU tensor. Like the JAX kernel it
is forward only (no gradient is defined) and no model calls it: it has its
own entry point, ``scripts/proto_conv_kernel_torch.py``.

The kernel has two routes, and :func:`plan` picks one by the dtype: bf16
takes ``"wgmma"`` (tensor cores fed by TMA through a ring of shared-memory
stages, a persistent grid of one block per SM walking 8³-voxel tiles ×
48 output channels), float32 takes ``"f32"`` (a direct kernel on the f32
pipes, for exact checks). ``conv3x3x3.launches`` counts the launches of
each route.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from multimodal_organ_segmentation_tpu_torch.ops import _build

CHANNEL_MULTIPLE = 8  # one 16-byte load of bf16 channels
ROUTES = ("wgmma", "f32")
SMEM_LIMIT = 232_448  # dynamic shared memory one block can use on Hopper (227 KB)
H100_SMS = 132
# the wgmma route, as csrc/conv3x3x3.cu builds it
TILE = 8  # output tile edge, D = H = W
CHUNK = 16  # input channels a ring stage (the wgmma depth)
N_BLOCK = 48  # output channels a work item (the wgmma width)
STAGES = 3
WGMMA_THREADS = 288  # two consumer warpgroups + one producer warp
HALO_GROUP_BYTES = (TILE + 2) ** 3 * 16  # one TMA box: 8 channels of the 10³ halo
STAGE_BYTES = 2 * HALO_GROUP_BYTES + 27 * 2 * N_BLOCK * 16  # halo + 27 taps' weights
F32_THREADS = 256
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "conv3x3x3_fwd_wgmma": (_I, [_P, _P, _P] + [_I] * 12 + [_P]),
    "conv3x3x3_fwd_f32": (_I, [_P, _P, _P] + [_I] * 9 + [_P]),
}


def plan(b: int, d: int, h: int, w: int, c: int, cout: int, dtype: torch.dtype,
         sms: int = H100_SMS) -> dict:
    """The route and launch plan of kernel C for one call: ``route``, ``grid``
    (blocks), ``threads`` a block, ``tile`` (output voxels a work item along
    D, H, W), ``stages`` of the shared-memory ring, ``nblock`` (output
    channels a work item) and ``smem`` (dynamic shared-memory bytes);
    the wgmma route also gives ``tiles`` (along D, H, W), ``nblocks``,
    ``chunks`` (16-channel stages an item) and ``items``. ``sms``: the
    card's multiprocessor count, one persistent block each.

    wgmma: items are (batch element, 8³ tile, 48-channel block), walked by
    ``min(items, sms)`` blocks, block ``i`` taking items ``i, i + grid, ...``
    (:func:`item_origin`); three stages of ``STAGE_BYTES`` plus 256 bytes
    of barriers and alignment. f32: one thread per output voxel and 8
    output channels, 256 threads a block, no shared memory."""
    if dtype == torch.bfloat16:
        tiles = tuple(math.ceil(n / TILE) for n in (d, h, w))
        nblocks = math.ceil(cout / N_BLOCK)
        items = b * math.prod(tiles) * nblocks
        return dict(route="wgmma", grid=min(items, sms), threads=WGMMA_THREADS, tile=(TILE,) * 3,
                    stages=STAGES, nblock=N_BLOCK, smem=STAGES * STAGE_BYTES + 256, tiles=tiles,
                    nblocks=nblocks, chunks=math.ceil(c / CHUNK), items=items)
    if dtype == torch.float32:
        grid = math.ceil(b * d * h * w * (cout // 8) / F32_THREADS)
        if grid > 2**31 - 1:
            raise ValueError(f"conv3x3x3: grid {grid} is too large")
        return dict(route="f32", grid=grid, threads=F32_THREADS, tile=(1, 1, 1), stages=0,
                    nblock=8, smem=0)
    raise TypeError(f"conv3x3x3: the kernel takes float32 or bfloat16, got {dtype}")


def item_origin(p: dict, item: int) -> tuple:
    """``(batch, d0, h0, w0, n0)``, the first output voxel and channel of
    work item ``item`` of a wgmma plan, decoded as the kernel decodes it
    (channel block fastest, then W, H, D tiles, then batch)."""
    item, nb = divmod(item, p["nblocks"])
    item, tw = divmod(item, p["tiles"][2])
    item, th = divmod(item, p["tiles"][1])
    b, td = divmod(item, p["tiles"][0])
    return b, td * TILE, th * TILE, tw * TILE, nb * N_BLOCK


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w ``[3, 3, 3, C, Cout]`` re-laid for the wgmma route as
    ``[ceil(Cout/48), ceil(C/16), 27, 2, 48, 8]``: element ``[nb, cc, tap,
    kg, n, j]`` is ``w[tap, cc*16 + kg*8 + j, nb*48 + n]`` (taps in (kd, kh,
    kw) order), zero past C or Cout. One (nb, cc) piece is the 41,472
    contiguous bytes that one ring stage brings with one bulk copy, each
    tap's [2][48][8] the wgmma's K-major B operand."""
    c, cout = w.shape[3], w.shape[4]
    chunks, nblocks = math.ceil(c / CHUNK), math.ceil(cout / N_BLOCK)
    padded = w.new_zeros((27, chunks * CHUNK, nblocks * N_BLOCK))
    padded[:, :c, :cout] = w.reshape(27, c, cout)
    return (padded.reshape(27, chunks, 2, 8, nblocks, N_BLOCK)
            .permute(4, 1, 0, 2, 5, 3).contiguous())


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
    kernel on the route :func:`plan` picks, or raises on anything the
    kernel does not take (C and Cout must be multiples of 8; any D, H, W).
    """
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3: unsupported device {x.device}")
    _check_kernel_inputs(x, w)
    b, d, h, wd, c = x.shape
    cout = w.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = plan(b, d, h, wd, c, cout, x.dtype, sms)
    out = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3x3x3", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (b, d, h, wd, c, cout)
    if p["route"] == "wgmma":
        wp = pack_weights(w.detach())
        err = lib.conv3x3x3_fwd_wgmma(x.data_ptr(), wp.data_ptr(), out.data_ptr(), *shape,
                                      p["grid"], p["threads"], p["smem"], p["stages"], p["nblock"],
                                      x.device.index, stream)
    else:
        # tap-major [27, Cout, C]: one output channel's inputs are contiguous
        wt = w.detach().reshape(27, c, cout).transpose(1, 2).contiguous()
        err = lib.conv3x3x3_fwd_f32(x.data_ptr(), wt.data_ptr(), out.data_ptr(), *shape,
                                    p["grid"], p["threads"], x.device.index, stream)
    _build.check(lib, err, f"conv3x3x3 ({p['route']} route)")
    conv3x3x3.launches[p["route"]] += 1
    return out


conv3x3x3.launches = dict.fromkeys(ROUTES, 0)
