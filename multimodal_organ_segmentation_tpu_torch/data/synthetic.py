"""Synthetic multimodal dataset generator (for tests and benchmarks).

The reference has no test data; this generator creates NIfTI volumes with
organ-like structures: per class a random ellipsoid with class-specific CT
intensity and PET uptake, so a model can actually learn the mapping and a
2-epoch training run shows improving Dice (SURVEY.md §4 integration-test
strategy).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, save_nifti

# per-class (CT HU, PET SUV) means: background + up to 7 organs
_CLASS_INTENSITY = [
    (-500.0, 0.1),  # background / air-ish
    (20.0, 1.0),    # bladder
    (35.0, 1.5),    # kidney L
    (35.0, 1.5),    # kidney R
    (45.0, 2.0),    # heart
    (55.0, 2.5),    # liver
    (50.0, 2.0),    # spleen
    (40.0, 3.0),    # brain
]


def synthetic_volume(
    shape: Tuple[int, int, int],
    num_classes: int,
    rng: np.random.Generator,
    modalities: Sequence[str] = ("CT", "PET"),
    noise: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One multi-modal volume + label map with ellipsoid 'organs'.

    Returns (image [H, W, D, C], label [H, W, D]).
    """
    h, w, d = shape
    label = np.zeros(shape, dtype=np.int32)
    grid = np.stack(
        np.meshgrid(np.arange(h), np.arange(w), np.arange(d), indexing="ij"), axis=-1
    ).astype(np.float64)

    for cls in range(1, num_classes):
        center = rng.uniform([h * 0.2, w * 0.2, d * 0.2], [h * 0.8, w * 0.8, d * 0.8])
        radii = rng.uniform(
            [h * 0.08, w * 0.08, d * 0.08], [h * 0.2, w * 0.2, d * 0.2]
        )
        dist = np.sum(((grid - center) / radii) ** 2, axis=-1)
        label[dist <= 1.0] = cls

    channels = []
    for mod in modalities:
        img = np.zeros(shape, dtype=np.float32)
        for cls in range(num_classes):
            ct_mu, pet_mu = _CLASS_INTENSITY[cls % len(_CLASS_INTENSITY)]
            mu = ct_mu if mod in ("CT", "MRI", "US") else pet_mu
            img[label == cls] = mu
        scale = noise if mod in ("CT", "MRI", "US") else noise * 0.02
        img += rng.normal(0, scale, size=shape).astype(np.float32)
        channels.append(img)

    return np.stack(channels, axis=-1).astype(np.float32), label


def generate_synthetic_dataset(
    root,
    n_train: int = 4,
    n_val: int = 2,
    n_test: int = 2,
    shape: Tuple[int, int, int] = (32, 32, 32),
    num_classes: int = 8,
    modalities: Sequence[str] = ("CT", "PET"),
    seed: int = 0,
    spacing: Tuple[float, float, float] = (1.5, 1.5, 2.0),
    noise: float = 10.0,
) -> Dict[str, str]:
    """Write a CSV-driven NIfTI dataset under ``root``.

    Layout: ``{root}/{split}/{patient}/{modality}.nii.gz`` + ``label.nii.gz``
    and ``{root}/{split}.csv`` with columns patient_id, <modalities>, label.

    Returns {split: csv_path}.
    """
    import pandas as pd

    root = ensure_dir(root)
    rng = np.random.default_rng(seed)
    affine = np.diag(list(spacing) + [1.0])

    csvs = {}
    for split, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        rows = []
        for i in range(n):
            pid = f"{split}_{i:03d}"
            pdir = ensure_dir(root / split / pid)
            image, label = synthetic_volume(shape, num_classes, rng, modalities, noise=noise)
            row = {"patient_id": pid}
            for c, mod in enumerate(modalities):
                p = pdir / f"{mod.lower()}.nii.gz"
                save_nifti(image[..., c], p, affine=affine)
                row[mod] = str(p.relative_to(root))
            lp = pdir / "label.nii.gz"
            save_nifti(label.astype(np.uint8), lp, affine=affine)
            row["label"] = str(lp.relative_to(root))
            rows.append(row)
        csv_path = root / f"{split}.csv"
        pd.DataFrame(rows).to_csv(csv_path, index=False)
        csvs[split] = str(csv_path)
    return csvs
