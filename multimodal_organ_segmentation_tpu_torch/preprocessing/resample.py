"""Spacing-aware volume resampling (port of the JAX package's
``preprocessing/resample.py``).

The reference config declares per-modality ``target_spacing``
(configs/default.yaml:29-40) but never implements it; here it is a real
op: resample a volume from its affine's spacing onto an isotropic/
anisotropic target grid (linear for images, nearest for labels) and update
the affine accordingly. The resize runs on the device through the port's
``ops/resize.py``; the affine stays float64 on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear, resize_nearest
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

Device = Optional[Union[str, torch.device]]

# numpy's 64-bit types as the JAX package holds them (64-bit mode off)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def preprocess_device(device: Device = None) -> torch.device:
    """``device``, or the card when None; no card and none named raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("preprocess: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def to_device(data, device: torch.device) -> torch.Tensor:
    """A numpy array (64-bit types narrowed to 32) as a tensor on ``device``;
    a tensor is moved there as it is."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    arr = np.asarray(data)
    arr = np.ascontiguousarray(arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def spacing_from_affine(affine: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)


def resample_volume(
    data: np.ndarray,
    affine: np.ndarray,
    target_spacing: Sequence[float],
    order: int = 1,
    device: Device = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Resample onto ``target_spacing``; returns (data, new_affine)."""
    spacing = spacing_from_affine(affine)
    target = np.asarray(target_spacing, dtype=np.float64)
    out_shape = tuple(
        max(1, int(round(s * sp / tp)))
        for s, sp, tp in zip(data.shape[:3], spacing, target)
    )
    vol = to_device(data, preprocess_device(device))
    if order == 0:
        out = resize_nearest(vol, out_shape, spatial_axes=(0, 1, 2))
    else:
        out = resize_linear(vol, out_shape, spatial_axes=(0, 1, 2))

    # scale the direction columns to the new spacing, keep origin
    new_affine = np.asarray(affine, dtype=np.float64).copy()
    for i in range(3):
        col = new_affine[:3, i]
        norm = np.linalg.norm(col)
        if norm > 0:
            new_affine[:3, i] = col / norm * target[i]
    return out.cpu().numpy(), new_affine


def resample_file(
    input_path,
    output_path,
    target_spacing: Sequence[float],
    order: int = 1,
    device: Device = None,
) -> str:
    data, affine = load_nifti(input_path, return_affine=True)
    out, new_affine = resample_volume(data, affine, target_spacing, order, device)
    save_nifti(out, output_path, affine=new_affine)
    return str(output_path)
