"""Volume resizing with scipy ``ndimage.zoom`` semantics (port of the JAX
package's ``ops/resize.py``).

- order=1 (images): output coord ``i`` samples input coord
  ``i * (in-1) / (out-1)`` with linear interpolation.
- order=0 (labels): same coords, rounded to the nearest index.

The ``[out, in]`` interpolation matrices are built in numpy exactly as the
JAX module builds them. A row holds at most two non-zero weights, so each
axis applies its matrix as those taps: two ``index_select``s along the axis
and a weighted sum in f32. That is the matrix product with its zero terms
left out; it stays exact in f32 whatever the card's TF32 setting (a dense
f32 matmul on CUDA may run in TF32, a global switch the loader threads must
not touch). ``F.interpolate`` is not used: its ``align_corners``
conventions are not scipy's.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] linear-interpolation matrix, align-corners mapping."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    if out_size == 1:
        m = np.zeros((1, in_size), dtype=np.float32)
        m[0, 0] = 1.0
        return m
    coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2) if in_size > 1 else np.zeros_like(lo)
    frac = coords - lo
    m = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    m[rows, lo] = (1.0 - frac).astype(np.float32)
    m[rows, np.minimum(lo + 1, in_size - 1)] += frac.astype(np.float32)
    return m


def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] nearest-neighbor selection matrix (scipy order=0)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    if out_size == 1:
        m = np.zeros((1, in_size), dtype=np.float32)
        m[0, 0] = 1.0
        return m
    coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    idx = np.floor(coords + 0.5).astype(np.int64)
    idx = np.clip(idx, 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), idx] = 1.0
    return m


def _taps(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A matrix's rows as two (column, weight) taps: ``index [2, out]``,
    ``weight [2, out]``. A row with one non-zero gets a second tap of
    weight 0 on the same column."""
    out = matrix.shape[0]
    index = np.zeros((2, out), np.int64)
    weight = np.zeros((2, out), np.float32)
    for r in range(out):
        cols = np.flatnonzero(matrix[r])
        if len(cols) > 2:
            raise ValueError("an interpolation row has more than two taps")
        index[:, r] = cols[0]
        for t, c in enumerate(cols):
            index[t, r], weight[t, r] = c, matrix[r, c]
    return index, weight


@functools.lru_cache(maxsize=256)
def _device_taps(linear: bool, in_size: int, out_size: int, device: torch.device):
    """The taps of a linear or nearest matrix as tensors on ``device``:
    ``[(index [out], weight [out]), ...]``, one pair per tap in use. Cached,
    so a transform on the card copies them to the device once per shape, not
    once per sample (each host-to-device copy of a pageable array would wait
    for the device)."""
    matrix = (_linear_matrix if linear else _nearest_matrix)(in_size, out_size)
    index, weight = _taps(matrix)
    return [(torch.from_numpy(index[t]).to(device), torch.from_numpy(weight[t]).to(device))
            for t in range(2 if weight[1].any() else 1)]


def _apply_axis(x: torch.Tensor, in_size: int, out_size: int, axis: int) -> torch.Tensor:
    """The linear matrix ``[out, in]`` contracted against ``x`` (f32) along
    ``axis``."""
    shape = [1] * x.dim()
    shape[axis] = out_size
    y = None
    for index, weight in _device_taps(True, in_size, out_size, x.device):
        term = x.index_select(axis, index) * weight.reshape(shape)
        y = term if y is None else y + term
    return y


def resize_linear(
    x: torch.Tensor,
    out_shape: Tuple[int, ...],
    spatial_axes: Tuple[int, ...] = (-3, -2, -1),
) -> torch.Tensor:
    """Linear resize of the given spatial axes to ``out_shape``."""
    axes = [a % x.dim() for a in spatial_axes]
    y = x.to(torch.float32)
    for axis, out_size in zip(axes, out_shape):
        y = _apply_axis(y, x.shape[axis], int(out_size), axis)
    return y.to(x.dtype)


def resize_nearest(
    x: torch.Tensor,
    out_shape: Tuple[int, ...],
    spatial_axes: Tuple[int, ...] = (-3, -2, -1),
) -> torch.Tensor:
    """Nearest-neighbor resize (labels): a pure selection, so integers stay
    exact."""
    axes = [a % x.dim() for a in spatial_axes]
    y = x
    for axis, out_size in zip(axes, out_shape):
        (index, _), = _device_taps(False, x.shape[axis], int(out_size), x.device)
        y = y.index_select(axis, index)
    return y


def resize_volume(
    image: torch.Tensor,
    out_shape: Tuple[int, int, int],
    order: int = 1,
    spatial_axes: Tuple[int, ...] = (-3, -2, -1),
) -> torch.Tensor:
    """scipy-zoom-compatible volume resize (order ∈ {0, 1})."""
    if order == 0:
        return resize_nearest(image, tuple(out_shape), tuple(spatial_axes))
    return resize_linear(image, tuple(out_shape), tuple(spatial_axes))


def upsample2x_linear(x: torch.Tensor, spatial_axes: Tuple[int, ...] = (1, 2, 3)) -> torch.Tensor:
    """2× trilinear upsample with align_corners=True."""
    out_shape = tuple(x.shape[a % x.dim()] * 2 for a in spatial_axes)
    return resize_linear(x, out_shape, tuple(spatial_axes))
