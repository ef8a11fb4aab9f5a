"""Per-organ SUV analysis (port of the JAX package's ``analysis/suv.py``).

The 7-organ label map; per organ the SUV max, mean, std (ddof 0), median
(the mean of the two middle values for an even count, as numpy's), min and
volume (ml from the header's zooms), and the volumes at 40/50/60% of the
organ's max; glob-based file discovery; CSV + XLSX export; ``analyze_tumor``
(SUV ≥ τ outside every organ). The statistics are float64 tensor functions
on the analyzer's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir
from multimodal_organ_segmentation_tpu_torch.utils.nifti import load as nifti_load
from multimodal_organ_segmentation_tpu_torch.utils.xlsx import save_table

ORGAN_LABELS = {
    1: "bladder",
    2: "kidney_right",
    3: "kidney_left",
    4: "heart",
    5: "liver",
    6: "spleen",
    7: "brain",
}

Device = Optional[Union[str, torch.device]]


def analysis_device(device: Device = None) -> torch.device:
    """``device``, or the card when None; no card and none named raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("analysis: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def find_file(directory: Path, patterns: List[str]) -> Optional[Path]:
    """First match over glob patterns, then recursive."""
    directory = Path(directory)
    for pattern in patterns:
        matches = sorted(directory.glob(pattern))
        if matches:
            return matches[0]
        matches = sorted(directory.rglob(pattern))
        if matches:
            return matches[0]
    return None


def load_suv(path, device: torch.device) -> Tuple[torch.Tensor, float, np.ndarray]:
    """An SUV volume as a float64 tensor on ``device`` (the values
    ``get_fdata`` gives), its voxel volume in ml and its affine."""
    img = nifti_load(path)
    voxel_ml = float(np.prod(img.header.get_zooms())) / 1000.0
    return torch.from_numpy(np.asarray(img.get_fdata())).to(device), voxel_ml, img.affine


def load_seg(path, device: torch.device) -> torch.Tensor:
    """A segmentation as an int32 tensor on ``device``."""
    return torch.from_numpy(nifti_load(path).get_fdata().astype(np.int32)).to(device)


def median(values: torch.Tensor) -> torch.Tensor:
    """numpy's median: the middle value, or the mean of the two middle
    values for an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(values).values
    m = s.numel() // 2
    return s[m] if s.numel() % 2 else (s[m - 1] + s[m]) / 2


def std(values: torch.Tensor) -> torch.Tensor:
    """numpy's ``std`` (ddof 0): the root of the mean squared deviation."""
    return ((values - values.mean()) ** 2).mean().sqrt()


def organ_stats(suv: torch.Tensor, seg: torch.Tensor, voxel_ml: float,
                labels: Dict[int, str] = ORGAN_LABELS) -> List[Dict[str, Any]]:
    """Per-organ SUV statistics of the organs present in ``seg``."""
    results = []
    for label_id, organ in labels.items():
        mask = seg == label_id
        vals = suv[mask]
        count = vals.numel()
        if count == 0:
            continue
        mx = vals.max()
        row = torch.stack([mx, vals.mean(), std(vals), median(vals), vals.min()]
                          + [(vals >= mx * pct / 100).sum().to(vals.dtype)
                             for pct in (40, 50, 60)]).tolist()
        stats = {
            "organ": organ,
            "label_id": label_id,
            "suv_max": row[0],
            "suv_mean": row[1],
            "suv_std": row[2],
            "suv_median": row[3],
            "suv_min": row[4],
            "volume_ml": float(count * voxel_ml),
            "volume_voxels": int(count),
        }
        for pct, n in zip((40, 50, 60), row[5:]):
            stats[f"suv_{pct}_volume"] = float(int(n) * voxel_ml)
        results.append(stats)
    return results


def tumor_candidates(suv: torch.Tensor, seg: torch.Tensor, voxel_ml: float,
                     threshold: float = 2.5) -> Dict[str, Any]:
    """SUV ≥ ``threshold`` outside every organ label."""
    vals = suv[(suv >= threshold) & ~(seg > 0)]
    if vals.numel() == 0:
        return {"num_lesions": 0, "total_volume_ml": 0, "max_suv": 0}
    mx, mean, med = torch.stack([vals.max(), vals.mean(), median(vals)]).tolist()
    return {
        "num_voxels": int(vals.numel()),
        "volume_ml": float(vals.numel() * voxel_ml),
        "suv_max": mx,
        "suv_mean": mean,
        "suv_median": med,
        "threshold_used": threshold,
    }


class SUVAnalyzer:
    """Organ-level SUV statistics over a predicted segmentation."""

    ORGAN_LABELS = ORGAN_LABELS

    def __init__(self, config=None, device: Device = None):
        self.config = config
        self.device = analysis_device(device)

    def analyze(self, input_path, output_path) -> Dict[str, Any]:
        input_path = Path(input_path)
        output_path = ensure_dir(output_path)

        suv_file = find_file(input_path, ["*suv*.nii*", "*SUV*.nii*"])
        seg_file = find_file(input_path, ["*seg*.nii*", "*label*.nii*", "*pred*.nii*"])
        if suv_file is None or seg_file is None:
            raise FileNotFoundError("SUV or segmentation file not found")

        suv, voxel_ml, _ = load_suv(suv_file, self.device)
        results = organ_stats(suv, load_seg(seg_file, self.device), voxel_ml, self.ORGAN_LABELS)
        save_table(results, output_path / "suv_analysis.csv", output_path / "suv_analysis.xlsx")
        return {
            "organs": results,
            "summary": {
                "num_organs_analyzed": len(results),
                "total_volume_ml": sum(r["volume_ml"] for r in results),
            },
        }

    def analyze_tumor(self, suv_path, seg_path, threshold: float = 2.5) -> Dict[str, Any]:
        """Tumour candidates: SUV ≥ τ outside all organ labels."""
        suv, voxel_ml, _ = load_suv(suv_path, self.device)
        return tumor_candidates(suv, load_seg(seg_path, self.device), voxel_ml, threshold)
