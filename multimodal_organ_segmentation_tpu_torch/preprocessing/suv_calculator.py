"""SUV calculation (reference: src/preprocessing/suv_calculator.py:19-282);
a copy of the JAX package's ``preprocessing/suv_calculator.py``, on the host.

Formulas preserved exactly:

- decay factor ``exp(−ln2·Δt/half_life)`` from DICOM HHMMSS[.frac] times
  with day rollover (suv_calculator.py:140-189);
- **bw**:        weight·1000 / corrected_dose
- **bsa**:       Du Bois 0.007184·w^0.425·h_cm^0.725, factor bsa·10000/dose
- **lbm_james**: sex-specific, floored at 0.5·weight
- **lbm_jan**:   Janmahasatian BMI-based

Pure-function core (``suv_factor``, ``decay_factor``) + a file-level
``SUVCalculator`` that mirrors the reference's IO behavior (reads
``pet.nii.gz`` + ``pet_metadata.npy``, writes ``pet_suv_{method}.nii.gz``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, load_nifti, save_nifti

SUV_METHODS = ("bw", "bsa", "lbm_james", "lbm_jan")


def time_to_seconds(time_str: str) -> float:
    """DICOM TM (HHMMSS[.frac]) → seconds since midnight."""
    s = str(time_str).strip()
    if "." in s:
        main, frac = s.split(".")
        fraction = float(f"0.{frac}")
    else:
        main, fraction = s, 0.0
    main = main.ljust(6, "0")
    return int(main[0:2]) * 3600 + int(main[2:4]) * 60 + int(main[4:6]) + fraction


def decay_factor(
    start_time: Optional[str],
    acquisition_time: Optional[str],
    half_life: Optional[float],
) -> float:
    """Radioactive decay correction between injection and acquisition."""
    if start_time is None or acquisition_time is None or half_life is None:
        return 1.0
    try:
        delta = time_to_seconds(acquisition_time) - time_to_seconds(start_time)
        if delta < 0:  # day rollover
            delta += 24 * 3600
        return math.exp(-math.log(2) * delta / float(half_life))
    except (ValueError, TypeError):
        return 1.0


def bsa_dubois(weight_kg: float, height_m: float) -> float:
    """Du Bois body surface area (m²)."""
    return 0.007184 * (weight_kg ** 0.425) * ((height_m * 100) ** 0.725)


def lbm_james(weight_kg: float, height_cm: float, sex: str) -> float:
    """James lean body mass (kg), floored at half the body weight."""
    if str(sex).upper() == "M":
        lbm = 1.10 * weight_kg - 128 * (weight_kg / height_cm) ** 2
    else:
        lbm = 1.07 * weight_kg - 148 * (weight_kg / height_cm) ** 2
    return max(lbm, weight_kg * 0.5)


def lbm_janmahasatian(weight_kg: float, height_cm: float, sex: str) -> float:
    """Janmahasatian lean body mass (kg)."""
    bmi = weight_kg / ((height_cm / 100) ** 2)
    if str(sex).upper() == "M":
        return (9270 * weight_kg) / (6680 + 216 * bmi)
    return (9270 * weight_kg) / (8780 + 244 * bmi)


def suv_factor(
    method: str,
    corrected_dose: float,
    weight_kg: float,
    height_m: Optional[float] = None,
    sex: str = "M",
) -> float:
    """Multiplicative factor turning activity-concentration (Bq/ml) into SUV."""
    if method == "bw":
        return weight_kg * 1000 / corrected_dose
    if method == "bsa":
        if height_m is None:
            raise ValueError("Patient height required for SUV_bsa")
        return bsa_dubois(weight_kg, height_m) * 10000 / corrected_dose
    if method == "lbm_james":
        if height_m is None:
            raise ValueError("Patient height required for SUV_lbm")
        return lbm_james(weight_kg, height_m * 100, sex) * 1000 / corrected_dose
    if method == "lbm_jan":
        if height_m is None:
            raise ValueError("Patient height required for SUV_lbm")
        return lbm_janmahasatian(weight_kg, height_m * 100, sex) * 1000 / corrected_dose
    raise ValueError(f"Unknown SUV method: {method}")


class SUVCalculator:
    """File-level SUV pipeline over converted PET volumes."""

    SUV_METHODS = SUV_METHODS

    def __init__(self, config=None):
        self.config = config
        methods = None
        if config is not None:
            methods = config.get("analysis.suv.methods")
        self.methods = list(methods) if methods else ["bw"]

    def calculate(
        self,
        pet_path,
        output_path,
        metadata: Optional[Dict[str, Any]] = None,
        methods: Optional[list] = None,
    ) -> Dict[str, str]:
        """Compute SUV volumes; returns {method: output_file}."""
        pet_path = Path(pet_path)
        if pet_path.is_dir():
            candidate = pet_path / "pet.nii.gz"
            pet_path = candidate if candidate.exists() else pet_path
        output_path = ensure_dir(output_path)
        methods = methods or self.methods

        pet_data, affine = load_nifti(pet_path, return_affine=True)

        if metadata is None:
            meta_file = Path(pet_path).parent / "pet_metadata.npy"
            if not meta_file.exists():
                raise ValueError("PET metadata required for SUV calculation")
            metadata = np.load(str(meta_file), allow_pickle=True).item()

        pet_info = metadata.get("pet_info", {})
        weight = pet_info.get("patient_weight")
        height = pet_info.get("patient_size")
        dose = pet_info.get("radionuclide_total_dose")
        half_life = pet_info.get("radionuclide_half_life")
        start = pet_info.get("radiopharmaceutical_start_time")
        acq = pet_info.get("acquisition_time") or pet_info.get("series_time")

        if weight is None or dose is None:
            raise ValueError("Patient weight and total dose required for SUV calculation")

        corrected_dose = float(dose) * decay_factor(start, acq, half_life)
        sex = metadata.get("patient_sex", "M")

        results = {}
        for method in methods:
            factor = suv_factor(
                method, corrected_dose, float(weight),
                float(height) if height is not None else None, sex,
            )
            suv = pet_data.astype(np.float32) * factor
            out_file = output_path / f"pet_suv_{method}.nii.gz"
            save_nifti(suv, out_file, affine=affine)
            results[method] = str(out_file)
        return results

    def get_suv_stats(
        self, suv_path, mask_path=None
    ) -> Dict[str, float]:
        """Masked SUV statistics (reference: suv_calculator.py:247-282)."""
        suv = load_nifti(suv_path)
        if mask_path is not None:
            mask = load_nifti(mask_path) > 0
            vals = suv[mask]
        else:
            vals = suv[suv > 0]
        if len(vals) == 0:
            return {"max": 0, "mean": 0, "std": 0, "median": 0}
        return {
            "max": float(np.max(vals)),
            "mean": float(np.mean(vals)),
            "std": float(np.std(vals)),
            "median": float(np.median(vals)),
            "min": float(np.min(vals)),
            "volume": int(len(vals)),
        }
