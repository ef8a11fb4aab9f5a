"""DICOM → NIfTI conversion (reference: src/preprocessing/dicom_converter.py);
a copy of the JAX package's ``preprocessing/dicom_converter.py``, on the host.

Behavioral contract preserved:

- slice sort: InstanceNumber → SliceLocation → ImagePositionPatient[2]
  (dicom_converter.py:104-113);
- CT/PET: RescaleSlope·x + RescaleIntercept (:127-129, :153-155); MRI raw;
  US: RGB→gray mean, single-slice → add depth axis (:224-232);
- affine from PixelSpacing/SliceThickness/IPP/IOP with cross-product slice
  direction (:242-268);
- metadata dict incl. the PET radiopharmaceutical sequence (dose,
  half-life, start time, :176-184), saved as ``{mod}_metadata.npy``;
- output ``{modality_lower}.nii.gz`` in the output dir.

Uses this package's own DICOM codec (preprocessing/dicom.py) — no pydicom.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from multimodal_organ_segmentation_tpu_torch.preprocessing import dicom as dcm
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, save_nifti


class DicomConverter:
    """Convert per-modality DICOM series to NIfTI volumes + metadata."""

    def __init__(self, config=None):
        self.config = config

    def convert(
        self,
        dicom_dir,
        output_dir,
        modality: str = "CT",
    ) -> Optional[str]:
        """Convert a DICOM directory; returns the NIfTI path (None if empty)."""
        dicom_dir = Path(dicom_dir)
        output_dir = ensure_dir(output_dir)

        files = self._load_dicom_series(dicom_dir)
        if not files:
            return None

        modality = modality.upper()
        if modality == "CT":
            volume, affine, metadata = self._convert_rescaled(files)
        elif modality == "PET":
            volume, affine, metadata = self._convert_pet(files)
        elif modality == "MRI":
            volume, affine, metadata = self._convert_mri(files)
        elif modality == "US":
            volume, affine, metadata = self._convert_ultrasound(files)
        else:
            volume, affine, metadata = self._convert_rescaled(files)

        out_path = output_dir / f"{modality.lower()}.nii.gz"
        save_nifti(volume, out_path, affine=affine)
        np.save(output_dir / f"{modality.lower()}_metadata.npy", metadata)  # type: ignore[arg-type]
        return str(out_path)

    # -- series loading ------------------------------------------------------

    def _load_dicom_series(self, dicom_dir: Path) -> List[dcm.Dataset]:
        files = []
        if not dicom_dir.exists():
            return files
        for f in sorted(dicom_dir.iterdir()):
            if f.is_file() and (
                f.suffix.lower() in (".dcm", "") or f.name.isdigit()
            ):
                try:
                    files.append(dcm.dcmread(f))
                except Exception:
                    continue

        def try_sort(key):
            try:
                files.sort(key=key)
                return True
            except (AttributeError, IndexError, TypeError):
                return False

        (
            try_sort(lambda d: float(d.InstanceNumber))
            or try_sort(lambda d: float(d.SliceLocation))
            or try_sort(lambda d: float(d.ImagePositionPatient[2]))
        )
        return files

    # -- modality conversions --------------------------------------------------

    @staticmethod
    def _frame_slices(ds: dcm.Dataset) -> List[np.ndarray]:
        """2-D grayscale slices from one file. A multi-frame file
        (enhanced CT/PET/MR, NumberOfFrames>1) is a slice stack in one
        file — the reference gets this for free from pydicom's
        ``[frames, rows, cols]`` pixel_array (dicom_converter.py:40-89);
        color pixel data is rejected here (only US handles RGB)."""
        px = ds.pixel_array.astype(np.float32)
        frames = int(getattr(ds, "NumberOfFrames", 1) or 1)
        if frames > 1:
            if px.ndim != 3:
                raise ValueError(
                    "multi-frame color DICOM is unsupported for CT/PET/MRI "
                    f"(pixel shape {px.shape})"
                )
            return list(px)
        if px.ndim != 2:
            raise ValueError(
                f"color pixel data (shape {px.shape}) is unsupported for "
                "CT/PET/MRI"
            )
        return [px]

    def _stack(self, files: List[dcm.Dataset], rescale: bool) -> np.ndarray:
        slices = []
        for ds in files:
            slope = float(getattr(ds, "RescaleSlope", 1) or 1)
            intercept = float(getattr(ds, "RescaleIntercept", 0) or 0)
            for px in self._frame_slices(ds):
                if rescale:
                    px = px * slope + intercept
                slices.append(px)
        return np.stack(slices, axis=-1)

    def _convert_rescaled(self, files):
        volume = self._stack(files, rescale=True)
        affine, spacing = self._get_affine(files[0])
        metadata = self._extract_metadata(files[0])
        metadata["spacing"] = spacing
        return volume, affine, metadata

    def _convert_pet(self, files):
        volume, affine, metadata = self._convert_rescaled(files)
        ds = files[0]
        pet_info: Dict[str, Any] = {
            "patient_weight": getattr(ds, "PatientWeight", None),
            "patient_size": getattr(ds, "PatientSize", None),
            "series_time": getattr(ds, "SeriesTime", None),
            "acquisition_time": getattr(ds, "AcquisitionTime", None),
        }
        seq = getattr(ds, "RadiopharmaceuticalInformationSequence", None)
        if seq:
            info = seq[0]
            pet_info.update(
                {
                    "radionuclide_total_dose": getattr(
                        info, "RadionuclideTotalDose", None
                    ),
                    "radionuclide_half_life": getattr(
                        info, "RadionuclideHalfLife", None
                    ),
                    "radiopharmaceutical_start_time": getattr(
                        info, "RadiopharmaceuticalStartTime", None
                    ),
                }
            )
        metadata["pet_info"] = pet_info
        return volume, affine, metadata

    def _convert_mri(self, files):
        volume = self._stack(files, rescale=False)
        affine, spacing = self._get_affine(files[0])
        metadata = self._extract_metadata(files[0])
        metadata["spacing"] = spacing
        ds = files[0]
        metadata["mri_info"] = {
            "sequence_name": getattr(ds, "SequenceName", None),
            "repetition_time": getattr(ds, "RepetitionTime", None),
            "echo_time": getattr(ds, "EchoTime", None),
            "magnetic_field_strength": getattr(ds, "MagneticFieldStrength", None),
        }
        return volume, affine, metadata

    def _convert_ultrasound(self, files):
        slices = []
        for ds in files:
            px = ds.pixel_array.astype(np.float32)
            # RGB → gray mean (single frame [R,C,3] or cine [F,R,C,3]);
            # SamplesPerPixel disambiguates from a 3-frame grayscale cine
            if (
                px.ndim >= 3
                and px.shape[-1] == 3
                and int(getattr(ds, "SamplesPerPixel", 1)) == 3
            ):
                px = np.mean(px, axis=-1)
            if px.ndim == 3:  # multi-frame cine → one slice per frame
                slices.extend(px)
            elif px.ndim == 2:
                slices.append(px)
            else:
                raise ValueError(f"unsupported US pixel shape {px.shape}")
        volume = (
            slices[0][..., np.newaxis] if len(slices) == 1 else np.stack(slices, axis=-1)
        )
        affine, spacing = self._get_affine(files[0])
        metadata = self._extract_metadata(files[0])
        metadata["spacing"] = spacing
        return volume, affine, metadata

    # -- geometry / metadata ---------------------------------------------------

    def _get_affine(self, ds: dcm.Dataset) -> Tuple[np.ndarray, np.ndarray]:
        ps = getattr(ds, "PixelSpacing", [1.0, 1.0])
        if not isinstance(ps, (list, tuple)):
            ps = [ps, ps]
        thickness = float(getattr(ds, "SliceThickness", 1.0) or 1.0)
        spacing = np.array([float(ps[0]), float(ps[1]), thickness])

        ipp = getattr(ds, "ImagePositionPatient", [0.0, 0.0, 0.0])
        position = np.array([float(p) for p in ipp])

        iop = getattr(ds, "ImageOrientationPatient", [1, 0, 0, 0, 1, 0])
        row = np.array([float(v) for v in iop[:3]])
        col = np.array([float(v) for v in iop[3:]])
        slc = np.cross(row, col)

        affine = np.eye(4)
        affine[:3, 0] = row * spacing[0]
        affine[:3, 1] = col * spacing[1]
        affine[:3, 2] = slc * spacing[2]
        affine[:3, 3] = position
        return affine, spacing

    def _extract_metadata(self, ds: dcm.Dataset) -> Dict[str, Any]:
        return {
            "patient_id": getattr(ds, "PatientID", "Unknown"),
            "patient_name": str(getattr(ds, "PatientName", "Unknown")),
            "patient_sex": getattr(ds, "PatientSex", "Unknown"),
            "patient_age": getattr(ds, "PatientAge", "Unknown"),
            "study_date": getattr(ds, "StudyDate", "Unknown"),
            "modality": getattr(ds, "Modality", "Unknown"),
            "manufacturer": getattr(ds, "Manufacturer", "Unknown"),
            "institution": getattr(ds, "InstitutionName", "Unknown"),
            "rows": getattr(ds, "Rows", 0),
            "columns": getattr(ds, "Columns", 0),
        }
