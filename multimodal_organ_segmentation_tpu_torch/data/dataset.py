"""Datasets: CSV-driven multimodal training data + label-free inference data.

Reference parity (src/data/dataset.py):

- ``MultiModalDataset`` (dataset.py:19-117): CSV with columns
  ``patient_id``, one per modality (NIfTI path), ``label``; loads each
  modality, stacks to channels-last ``[H, W, D, C]`` float32, label
  ``[H, W, D]`` int32; sample dict {image, label, patient_id, affine}.
- ``InferenceDataset`` (dataset.py:120-176): built from
  ``{modality: [paths]}`` without labels.

Host-side numpy only — device work happens in the transform pipeline and
the loader's prefetch.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti


class _CacheBudget:
    """Process-global decoded-volume cache accounting.

    ``data.cache_gb`` is a HOST-RAM budget, so it must bound the sum across
    every dataset instance in the process (train+val+test splits), not be
    granted once per split — otherwise a run that builds train and val
    loaders caches up to 2x the configured budget.
    """

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.used = 0

    def try_charge(self, nbytes: int, limit: int) -> bool:
        with self.lock:
            if self.used + nbytes <= limit:
                self.used += nbytes
                return True
            return False

    def release(self, nbytes: int) -> None:
        with self.lock:
            self.used -= nbytes


_CACHE_BUDGET = _CacheBudget()


class MultiModalDataset:
    """CSV-driven multi-modality segmentation dataset."""

    def __init__(
        self,
        csv_path,
        data_root,
        modalities: Sequence[str],
        transform=None,
        cache_bytes: int = 0,
    ):
        """``cache_bytes`` > 0 keeps decoded pre-transform samples in host
        RAM up to that budget (first-epoch insertion order): later epochs
        skip the NIfTI read+gunzip+decode entirely — on clinical volumes
        that IO dominates a CPU loader worker. Random augmentations still
        vary per epoch (they run in the transform, after the cache). The
        reference re-decodes every file every epoch (dataset.py:19-117)."""
        import threading

        import pandas as pd

        self.data_root = Path(data_root)
        self.modalities = list(modalities)
        self.transform = transform
        self.df = pd.read_csv(csv_path)
        self.cache_bytes = int(cache_bytes or 0)
        self._cache: Dict[int, Dict[str, Any]] = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()

        missing = [
            c for c in ["patient_id", "label", *self.modalities] if c not in self.df.columns
        ]
        if missing:
            raise ValueError(f"dataset CSV missing columns: {missing}")

    def __len__(self) -> int:
        return len(self.df)

    def _resolve(self, p: str) -> Path:
        path = Path(p)
        return path if path.is_absolute() else self.data_root / path

    def load_raw(self, idx: int) -> Dict[str, Any]:
        if self.cache_bytes:
            with self._cache_lock:
                hit = self._cache.get(idx)
            if hit is not None:
                # shallow copy: transforms replace dict values, never
                # mutate the cached arrays in place
                return dict(hit)
        row = self.df.iloc[idx]
        channels = []
        affine = None
        for mod in self.modalities:
            vol, aff = load_nifti(self._resolve(row[mod]), return_affine=True)
            channels.append(vol.astype(np.float32))
            if affine is None:
                affine = aff
        image = np.stack(channels, axis=-1)  # [H, W, D, C]
        label = load_nifti(self._resolve(row["label"]), dtype=np.int32)
        sample = {
            "image": image,
            "label": label.astype(np.int32),
            "patient_id": str(row["patient_id"]),
            "affine": affine,
        }
        if self.cache_bytes:
            nbytes = image.nbytes + sample["label"].nbytes
            with self._cache_lock:
                if idx not in self._cache and _CACHE_BUDGET.try_charge(
                    nbytes, self.cache_bytes
                ):
                    self._cache[idx] = dict(sample)
                    self._cache_used += nbytes
        return sample

    def __del__(self):
        # return this instance's share of the process-global budget so
        # short-lived datasets (eval scripts, tests) don't leak it
        try:
            _CACHE_BUDGET.release(self._cache_used)
        except Exception:
            pass

    def get_sample(self, idx: int, epoch: Optional[int] = None) -> Dict[str, Any]:
        """Fetch + transform; with ``epoch`` given, transform randomness is
        the stateless (seed, epoch, idx) key (resume/multi-host stable)."""
        sample = self.load_raw(idx)
        if self.transform is not None:
            if epoch is not None and hasattr(self.transform, "key_for"):
                sample = self.transform(
                    sample, key=self.transform.key_for(epoch, idx)
                )
            else:
                sample = self.transform(sample)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.get_sample(idx)


class InferenceDataset:
    """Label-free dataset from explicit per-modality path lists."""

    def __init__(
        self,
        modality_paths: Dict[str, List],
        transform=None,
    ):
        self.modalities = list(modality_paths.keys())
        lengths = {len(v) for v in modality_paths.values()}
        if len(lengths) != 1:
            raise ValueError("all modalities must have the same number of cases")
        self.paths = modality_paths
        self.transform = transform

    def __len__(self) -> int:
        return len(next(iter(self.paths.values())))

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        channels = []
        affine = None
        for mod in self.modalities:
            vol, aff = load_nifti(self.paths[mod][idx], return_affine=True)
            channels.append(vol.astype(np.float32))
            if affine is None:
                affine = aff
        sample: Dict[str, Any] = {
            "image": np.stack(channels, axis=-1),
            "patient_id": Path(str(self.paths[self.modalities[0]][idx])).stem.split(".")[0],
            "affine": affine,
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


def get_dataset(config, split: str = "train", transform=None) -> MultiModalDataset:
    """Dataset factory (reference: dataset.py:179-217)."""
    data_cfg = config.get("data", {})
    data_root = data_cfg.get("data_root", "./data")
    csv_name = data_cfg.get(f"{split}_csv", f"{split}.csv")
    csv_path = Path(csv_name)
    if not csv_path.is_absolute():
        csv_path = Path(data_root) / csv_name
    return MultiModalDataset(
        csv_path=csv_path,
        data_root=data_root,
        modalities=data_cfg.get("modalities", ["CT", "PET"]),
        transform=transform,
        cache_bytes=int(float(data_cfg.get("cache_gb", 0) or 0) * 2**30),
    )
