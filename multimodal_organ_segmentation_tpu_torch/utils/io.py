"""Host-side IO: NIfTI, JSON, file discovery.

Codec work is IO-bound, not an accelerator perf target (SURVEY.md §2.9), so NIfTI
runs host-side through this framework's own pure-numpy NIfTI-1 codec
(utils/nifti.py) — no nibabel dependency. Mirrors the reference surface
(src/utils/io.py:54-195).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from multimodal_organ_segmentation_tpu_torch.utils import nifti as _nifti


def ensure_dir(path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def load_nifti(
    path,
    return_affine: bool = False,
    return_header: bool = False,
    dtype=np.float32,
):
    """Load a NIfTI volume as a numpy array (reference: io.py:54-98)."""
    img = _nifti.load(str(path))
    data = np.asarray(img.get_fdata(), dtype=dtype)
    out: list = [data]
    if return_affine:
        out.append(img.affine)
    if return_header:
        out.append(img.header)
    return out[0] if len(out) == 1 else tuple(out)


def load_case_channels(paths, modalities: Sequence[str]):
    """Stack one case's per-modality NIfTIs into ``[H, W, D, C]`` float32.

    Returns ``(image, affine)`` where the affine is the first modality's
    (all modalities of a case share a grid after registration). Shared by
    the batch CLI (``Trainer.predict``) and the HTTP serving path.
    """
    channels, affine = [], None
    for mod in modalities:
        vol, aff = load_nifti(paths[mod], return_affine=True)
        channels.append(np.asarray(vol, dtype=np.float32))
        if affine is None:
            affine = aff
    return np.stack(channels, axis=-1), affine


def save_nifti(data, path, affine=None, dtype=None) -> None:
    """Save a numpy array as NIfTI (reference: io.py:101-131)."""
    arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(dtype)
    ensure_dir(Path(path).parent)
    _nifti.save(arr, str(path), affine=affine)


def load_json(path) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(data: Any, path, indent: int = 2) -> None:
    ensure_dir(Path(path).parent)

    def _default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(f"not JSON serializable: {type(o)}")

    with open(path, "w") as f:
        json.dump(data, f, indent=indent, default=_default)


def get_file_list(
    directory,
    extensions: Optional[Sequence[str]] = None,
    recursive: bool = False,
) -> List[Path]:
    """List files under ``directory`` filtered by extension
    (reference: io.py:160-195)."""
    d = Path(directory)
    if not d.exists():
        return []
    it = d.rglob("*") if recursive else d.glob("*")
    files = [p for p in it if p.is_file()]
    if extensions:
        exts = tuple(e if e.startswith(".") else "." + e for e in extensions)
        # handle .nii.gz style double extensions
        files = [p for p in files if str(p).endswith(exts)]
    return sorted(files)
