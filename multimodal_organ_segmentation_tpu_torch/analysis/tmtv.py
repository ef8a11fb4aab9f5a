"""TMTV / TLG analysis (port of the JAX package's ``analysis/tmtv.py``).

Threshold semantics as the JAX package's:

- tumour region = ``(seg == 0) | (seg > 7)`` (background or unknown), the
  whole volume without a segmentation;
- absolute: SUV ≥ 2.5 (``analysis.tmtv.absolute_threshold``);
- percentage: SUV ≥ 40% of the max in the tumour region;
- liver-based: SUV ≥ mean + 2σ (ddof 0) of the label-5 liver voxels;
- TLG = volume (ml) × mean SUV over the absolute-threshold mask;
- SUVpeak = the mean over the 7³ neighbourhood (cut at the volume's edge)
  of the masked max voxel, the first in C order where several tie;
- a binary mask per method + a CSV/XLSX summary.

The methods are float64 tensor functions on the analyzer's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.analysis.suv import (
    Device,
    analysis_device,
    find_file,
    load_seg,
    load_suv,
    std,
)
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, save_nifti
from multimodal_organ_segmentation_tpu_torch.utils.xlsx import save_table


def tumor_region_mask(seg: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if seg is None:
        return torch.ones_like(like, dtype=torch.bool)
    return (seg == 0) | (seg > 7)


class TMTVAnalyzer:
    """Total Metabolic Tumour Volume by three thresholding methods."""

    def __init__(self, config=None, device: Device = None):
        self.config = config
        self.device = analysis_device(device)
        tm = (config.get("analysis.tmtv", {}) or {}) if config is not None else {}
        self.absolute_threshold = float(tm.get("absolute_threshold", 2.5))
        self.percentage_threshold = float(tm.get("percentage_threshold", 0.4))

    # -- public API -----------------------------------------------------------

    def analyze(self, input_path, output_path) -> Dict[str, Any]:
        input_path = Path(input_path)
        output_path = ensure_dir(output_path)

        suv_file = find_file(input_path, ["*suv*.nii*", "*SUV*.nii*", "*pet*.nii*"])
        seg_file = find_file(input_path, ["*seg*.nii*", "*label*.nii*", "*pred*.nii*"])
        if suv_file is None:
            raise FileNotFoundError("SUV file not found")

        suv, voxel_ml, affine = load_suv(suv_file, self.device)
        seg = load_seg(seg_file, self.device) if seg_file is not None else None

        def save_mask(method, name):
            save_nifti(self.tmtv_mask(suv, seg, method).cpu().numpy(), output_path / name,
                       affine=affine, dtype=np.uint8)

        results: Dict[str, Any] = {"absolute": self.tmtv_absolute(suv, seg, voxel_ml)}
        save_mask("absolute", "tmtv_absolute.nii.gz")
        results["percentage"] = self.tmtv_percentage(suv, seg, voxel_ml)
        save_mask("percentage", "tmtv_percentage.nii.gz")
        if seg is not None:
            results["liver_based"] = self.tmtv_liver_based(suv, seg, voxel_ml)
            save_mask("liver", "tmtv_liver_based.nii.gz")
        results["tlg"] = self.tlg(suv, seg, voxel_ml)

        save_table([{"metric": k, **v} for k, v in results.items()],
                   output_path / "tmtv_analysis.csv", output_path / "tmtv_analysis.xlsx")
        return results

    # -- methods ---------------------------------------------------------------

    def _region_max(self, suv: torch.Tensor, region: torch.Tensor) -> float:
        return float((suv[region] if region.any() else suv).max())

    def _liver_threshold(self, suv, seg):
        """(mean, std, mean + 2·std) of the liver's SUV, or None without liver."""
        liver_vals = suv[seg == 5]
        if liver_vals.numel() == 0:
            return None
        mean_l, std_l = torch.stack([liver_vals.mean(), std(liver_vals)]).tolist()
        return mean_l, std_l, mean_l + 2 * std_l

    def _masked(self, suv, mask, voxel_ml) -> Dict[str, Any]:
        vals = suv[mask]
        mx, mean = torch.stack([vals.max(), vals.mean()]).tolist()
        return {"volume_ml": float(vals.numel() * voxel_ml), "suv_max": mx, "suv_mean": mean,
                "num_voxels": int(vals.numel())}

    def tmtv_absolute(self, suv, seg, voxel_ml) -> Dict[str, Any]:
        mask = (suv >= self.absolute_threshold) & tumor_region_mask(seg, suv)
        if not mask.any():
            return {"volume_ml": 0, "suv_max": 0, "suv_mean": 0,
                    "threshold": self.absolute_threshold}
        m = self._masked(suv, mask, voxel_ml)
        return {"volume_ml": m["volume_ml"], "suv_max": m["suv_max"], "suv_mean": m["suv_mean"],
                "suv_peak": self.suv_peak(suv, mask), "num_voxels": m["num_voxels"],
                "threshold": self.absolute_threshold}

    def tmtv_percentage(self, suv, seg, voxel_ml) -> Dict[str, Any]:
        region = tumor_region_mask(seg, suv)
        threshold = self._region_max(suv, region) * self.percentage_threshold
        mask = (suv >= threshold) & region
        if not mask.any():
            return {"volume_ml": 0, "suv_max": 0, "suv_mean": 0, "threshold": threshold,
                    "percentage": self.percentage_threshold}
        return {**self._masked(suv, mask, voxel_ml), "threshold": float(threshold),
                "percentage": self.percentage_threshold}

    def tmtv_liver_based(self, suv, seg, voxel_ml) -> Dict[str, Any]:
        liver = self._liver_threshold(suv, seg)
        if liver is None:
            return {"volume_ml": 0, "error": "Liver not found in segmentation"}
        mean_l, std_l, threshold = liver
        mask = (suv >= threshold) & tumor_region_mask(seg, suv)
        if not mask.any():
            return {"volume_ml": 0, "suv_max": 0, "suv_mean": 0, "threshold": threshold,
                    "liver_mean": mean_l, "liver_std": std_l}
        return {**self._masked(suv, mask, voxel_ml), "threshold": float(threshold),
                "liver_mean": mean_l, "liver_std": std_l}

    def tlg(self, suv, seg, voxel_ml) -> Dict[str, Any]:
        mask = (suv >= self.absolute_threshold) & tumor_region_mask(seg, suv)
        if not mask.any():
            return {"tlg": 0, "volume_ml": 0, "mean_suv": 0}
        m = self._masked(suv, mask, voxel_ml)
        return {"tlg": m["volume_ml"] * m["suv_mean"], "volume_ml": m["volume_ml"],
                "mean_suv": m["suv_mean"]}

    def suv_peak(self, suv: torch.Tensor, mask: torch.Tensor, neighborhood: int = 3) -> float:
        """Mean over the (2n+1)³ neighbourhood of the masked max voxel; the
        first maximum in C order (``np.argmax``'s, as ``torch.argmax``'s)."""
        masked = torch.where(mask, suv, torch.full_like(suv, -torch.inf))
        idx = np.unravel_index(int(torch.argmax(masked)), tuple(suv.shape))
        slices = tuple(slice(max(0, i - neighborhood), min(s, i + neighborhood + 1))
                       for i, s in zip(idx, suv.shape))
        return float(suv[slices].mean())

    def tmtv_mask(self, suv, seg, method: str = "absolute") -> torch.Tensor:
        region = tumor_region_mask(seg, suv)
        threshold = self.absolute_threshold
        if method == "percentage":
            threshold = self._region_max(suv, region) * self.percentage_threshold
        elif method == "liver" and seg is not None:
            liver = self._liver_threshold(suv, seg)
            if liver is not None:
                threshold = liver[2]
        return ((suv >= threshold) & region).to(torch.uint8)
