"""Intensity normalization (reference: src/preprocessing/normalizer.py:12-243);
a copy of the JAX package's ``preprocessing/normalizer.py``.

Array-level modality normalizers with the reference's exact semantics:

- CT: window (center/width) → clip → scale to output_range;
- PET: max / percentile-99-of-positives / reference-value division;
- MRI: zscore over a foreground mask (> p1), or minmax/percentile clipping;
- US: minmax or zscore;
- dispatcher ``normalize(image, modality)`` and file-level
  ``normalize_file``.

numpy host-side (these run in the offline preprocess stage); the on-device
training-time equivalents live in data/transforms.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, load_nifti, save_nifti


class IntensityNormalizer:
    """Modality-specific intensity normalization."""

    def __init__(self, config=None):
        self.config = config or {}

    def normalize_ct(
        self,
        image: np.ndarray,
        window_center: float = 0,
        window_width: float = 400,
        output_range: Tuple[float, float] = (0, 1),
    ) -> np.ndarray:
        lo = window_center - window_width / 2
        hi = window_center + window_width / 2
        x = np.clip(image, lo, hi)
        x = (x - lo) / (hi - lo)
        x = x * (output_range[1] - output_range[0]) + output_range[0]
        return x.astype(np.float32)

    def normalize_pet(
        self,
        image: np.ndarray,
        method: str = "max",
        reference_value: Optional[float] = None,
    ) -> np.ndarray:
        if method == "max":
            mx = image.max()
            x = image / mx if mx > 0 else image.copy()
        elif method == "percentile":
            p = np.percentile(image[image > 0], 99) if np.any(image > 0) else 1.0
            x = np.clip(image / p, 0, 1)
        elif method == "reference":
            if reference_value is None:
                raise ValueError("reference_value required for reference normalization")
            x = np.clip(image / reference_value, 0, None)
        else:
            x = image.copy()
        return x.astype(np.float32)

    def normalize_mri(
        self,
        image: np.ndarray,
        method: str = "zscore",
        percentile_range: Tuple[float, float] = (1, 99),
    ) -> np.ndarray:
        threshold = np.percentile(image, percentile_range[0])
        mask = image > threshold
        if method == "zscore":
            if mask.sum() > 0:
                mean = image[mask].mean()
                std = image[mask].std() + 1e-8
                x = (image - mean) / std
            else:
                x = image.copy()
        elif method in ("minmax", "percentile"):
            lo = np.percentile(image, percentile_range[0])
            hi = np.percentile(image, percentile_range[1])
            x = np.clip(image, lo, hi)
            x = (x - lo) / (hi - lo + 1e-8)
        else:
            x = image.copy()
        return x.astype(np.float32)

    def normalize_ultrasound(
        self, image: np.ndarray, method: str = "minmax"
    ) -> np.ndarray:
        if method == "minmax":
            lo, hi = image.min(), image.max()
            x = (image - lo) / (hi - lo) if hi - lo > 1e-8 else image.copy()
        elif method == "zscore":
            x = (image - image.mean()) / (image.std() + 1e-8)
        else:
            x = image.copy()
        return x.astype(np.float32)

    def normalize(self, image: np.ndarray, modality: str, **kwargs) -> np.ndarray:
        modality = modality.upper()
        if modality == "CT":
            return self.normalize_ct(image, **kwargs)
        if modality == "PET":
            return self.normalize_pet(image, **kwargs)
        if modality == "MRI":
            return self.normalize_mri(image, **kwargs)
        if modality == "US":
            return self.normalize_ultrasound(image, **kwargs)
        lo, hi = image.min(), image.max()
        if hi - lo > 1e-8:
            return ((image - lo) / (hi - lo)).astype(np.float32)
        return image.astype(np.float32)

    def normalize_file(
        self, input_path, output_path, modality: str, **kwargs
    ) -> str:
        data, affine = load_nifti(input_path, return_affine=True)
        out = self.normalize(data, modality, **kwargs)
        output_path = Path(output_path)
        ensure_dir(output_path.parent)
        save_nifti(out, output_path, affine=affine)
        return str(output_path)
