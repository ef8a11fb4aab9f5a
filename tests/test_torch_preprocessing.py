"""The port's ``preprocessing/`` (the DICOM codec, the converter, SUV, the
normalizer, the spacing resample) and ``--mode preprocess`` against the JAX
package, on the CPU from numpy seeds; the registration is
``tests/test_torch_registration.py``.

Tolerances: resample 1e-6 and its affine exact; the DICOM codec, the
converter's NIfTI and metadata, SUV's volumes and the normalizer exact; the
CLI's volumes 1e-5 and its transform parameters 1e-3 (MI, 3 iterations on
one level: across more, f32 rounding parts the two packages' MI paths).

Each test loops over its cases: xdist's ``loadfile`` sends files with many
tests first, and this file's JAX references must not delay the suite's
longest file.
"""

import gzip
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from multimodal_organ_segmentation_tpu import cli as jcli
from multimodal_organ_segmentation_tpu.preprocessing import dicom as jdcm
from multimodal_organ_segmentation_tpu.preprocessing import suv_calculator as jsuv
from multimodal_organ_segmentation_tpu.preprocessing.dicom_converter import (
    DicomConverter as JConverter,
)
from multimodal_organ_segmentation_tpu.preprocessing.normalizer import (
    IntensityNormalizer as JNormalizer,
)
from multimodal_organ_segmentation_tpu.preprocessing.resample import (
    resample_volume as jresample_volume,
)
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch import cli
from multimodal_organ_segmentation_tpu_torch.preprocessing import dicom as tdcm
from multimodal_organ_segmentation_tpu_torch.preprocessing import suv_calculator as tsuv
from multimodal_organ_segmentation_tpu_torch.preprocessing import (
    DicomConverter,
    ImageRegistration,
    IntensityNormalizer,
    SUVCalculator,
)
from multimodal_organ_segmentation_tpu_torch.preprocessing.resample import (
    resample_file,
    resample_volume,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.torch_port_utils import _one_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _nifti_bytes(path) -> bytes:
    """A ``.nii.gz`` file's NIfTI bytes: the gzip header holds the write's
    second, which two writes need not share."""
    return gzip.decompress(Path(path).read_bytes())


def _smooth_volume(shape, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.normal(size=shape), 2).astype(np.float32)


# --------------------------------------------------------------------------
# the spacing resample and the device rule
# --------------------------------------------------------------------------

def test_resample_volume():
    """Linear on f32 images, nearest on int64 labels (narrowed to int32, as
    JAX holds them)."""
    rng = np.random.default_rng(8)
    affine = np.array([[0.9, 0, 0, -10], [0, 1.1, 0, 4], [0, 0, 3.3, 7], [0, 0, 0, 1]])
    for order, data in ((0, rng.integers(0, 4, (12, 13, 9)).astype(np.int64)),
                        (1, rng.normal(size=(20, 19, 10)).astype(np.float32))):
        want, want_aff = jresample_volume(data, affine, (1.5, 1.5, 2.0), order=order)
        got, got_aff = resample_volume(data, affine, (1.5, 1.5, 2.0), order=order, device="cpu")
        assert got.shape == np.asarray(want).shape and got.dtype == np.asarray(want).dtype, order
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6, err_msg=str(order))
        np.testing.assert_array_equal(got_aff, want_aff)


def test_resample_file_keeps_the_half_to_even_shape(tmp_path):
    """16 × 1.5 / 1.0 = 24 and 5 × 2.5 / 1.0 = 12.5 → 12 (half to even)."""
    vol = _smooth_volume((16, 16, 5), 9)
    save_nifti(vol, tmp_path / "v.nii.gz", affine=np.diag([1.5, 1.5, 2.5, 1.0]))
    out = resample_file(tmp_path / "v.nii.gz", tmp_path / "r.nii.gz", (1.0, 1.0, 1.0),
                        device="cpu")
    data, aff = load_nifti(out, return_affine=True)
    assert data.shape == (24, 24, 12)
    np.testing.assert_allclose(np.diag(aff), [1, 1, 1, 1])


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageRegistration()
    with pytest.raises(RuntimeError, match="CUDA"):
        resample_volume(np.zeros((4, 4, 4), np.float32), np.eye(4), (1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageRegistration.resample_to_fixed_grid(np.zeros((4, 4, 4), np.float32), np.eye(4),
                                                 (4, 4, 4), np.eye(4))


# --------------------------------------------------------------------------
# the DICOM codec, the converter, SUV and the normalizer (copies)
# --------------------------------------------------------------------------

def test_dicom_codec_round_trips_across_packages(tmp_path):
    attrs = {"Modality": "PT", "PatientWeight": 70.5, "PixelSpacing": [1.5, 1.5],
             "ImagePositionPatient": [-10.25, 3.5, 7.0], "PatientName": "Test^Patient",
             "Rows": 4, "Columns": 6, "BitsAllocated": 16, "PixelRepresentation": 1,
             "RadiopharmaceuticalInformationSequence": [
                 {"RadionuclideTotalDose": 3.7e8, "RadionuclideHalfLife": 6586.2,
                  "RadiopharmaceuticalStartTime": "083000"}]}
    px = np.arange(-12, 12, dtype=np.int16).reshape(4, 6)
    tdcm.dcmwrite(tmp_path / "port.dcm", attrs, pixel_array=px)
    jdcm.dcmwrite(tmp_path / "jax.dcm", attrs, pixel_array=px)
    assert (tmp_path / "port.dcm").read_bytes() == (tmp_path / "jax.dcm").read_bytes()
    for reader in (tdcm.dcmread, jdcm.dcmread):
        ds = reader(tmp_path / "port.dcm")
        assert ds.PatientWeight == pytest.approx(70.5) and ds.PixelSpacing == [1.5, 1.5]
        assert ds.RadiopharmaceuticalInformationSequence[0].RadiopharmaceuticalStartTime \
            == "083000"
        np.testing.assert_array_equal(ds.pixel_array, px)
    (tmp_path / "bad.dcm").write_bytes(b"\x00" * 40)
    for reader in (tdcm.dcmread, jdcm.dcmread):
        with pytest.raises(ValueError):
            reader(tmp_path / "bad.dcm")


def _write_series(root: Path, kind: str) -> None:
    """The JAX tests' series writers: a reversed CT series, a PET slice with
    the SUV tags, an MRI series, a single RGB ultrasound frame, an RGB cine,
    the enhanced-CT golden file."""
    rng = np.random.default_rng(11)
    base = {"Rows": 6, "Columns": 5, "BitsAllocated": 16, "SamplesPerPixel": 1,
            "PatientID": "P001", "PatientSex": "F"}
    if kind in ("CT", "MRI"):
        for i in range(4):
            tags = {**base, "Modality": kind, "InstanceNumber": 4 - i,
                    "ImagePositionPatient": [0.0, 0.0, float(4 - i) * 2.0],
                    "ImageOrientationPatient": [1, 0, 0, 0, 1, 0], "PixelSpacing": [0.97, 0.8],
                    "SliceThickness": 2.0, "PixelRepresentation": 0}
            if kind == "CT":
                tags.update({"RescaleSlope": 1.0, "RescaleIntercept": -1024.0})
            else:
                tags.update({"RepetitionTime": 500.0, "EchoTime": 12.0, "SequenceName": "T1"})
            tdcm.dcmwrite(root / f"s{i:03d}.dcm", tags,
                          pixel_array=rng.integers(0, 2000, (6, 5)).astype(np.uint16))
    elif kind == "PET":
        tdcm.dcmwrite(root / "p0.dcm", {
            **base, "Modality": "PT", "PatientWeight": 75.0, "PatientSize": 1.8,
            "InstanceNumber": 1, "AcquisitionTime": "093000", "SeriesTime": "093000",
            "RescaleSlope": 0.5, "RescaleIntercept": 0.0,
            "RadiopharmaceuticalInformationSequence": [
                {"RadionuclideTotalDose": 3.0e8, "RadionuclideHalfLife": 6586.2,
                 "RadiopharmaceuticalStartTime": "083000"}]},
            pixel_array=rng.integers(0, 900, (6, 5)).astype(np.uint16))
    elif kind == "US":
        rgb = rng.integers(0, 255, (4, 4, 3)).astype(np.uint8)
        tdcm.dcmwrite(root / "u0.dcm", {"Modality": "US", "InstanceNumber": 1, "Rows": 4,
                                         "Columns": 4, "BitsAllocated": 8,
                                         "SamplesPerPixel": 3}, pixel_array=rgb)
    elif kind == "US-cine":
        rgb = rng.integers(0, 255, (3, 4, 4, 3)).astype(np.uint8)
        tdcm.dcmwrite(root / "cine.dcm", {"Modality": "US", "InstanceNumber": 1,
                                           "NumberOfFrames": 3, "Rows": 4, "Columns": 4,
                                           "BitsAllocated": 8, "SamplesPerPixel": 3},
                      pixel_array=rgb)
    elif kind == "CT-multiframe":
        root.mkdir(parents=True, exist_ok=True)
        shutil.copy(FIXTURES / "golden_multiframe_le.dcm", root / "vol.dcm")


def test_converter_matches_jax(tmp_path):
    """The CT/PET/MRI/US branches, with a multi-frame CT and an RGB cine."""
    for kind in ("CT", "PET", "MRI", "US", "US-cine", "CT-multiframe"):
        root = tmp_path / kind
        _write_series(root / "dicom", kind)
        modality = kind.split("-")[0]
        want = JConverter().convert(root / "dicom", root / "jax", modality=modality)
        got = DicomConverter().convert(root / "dicom", root / "port", modality=modality)
        assert Path(got).name == Path(want).name == f"{modality.lower()}.nii.gz", kind
        assert _nifti_bytes(got) == _nifti_bytes(want), kind
        meta = [np.load(d / f"{modality.lower()}_metadata.npy", allow_pickle=True).item()
                for d in (root / "port", root / "jax")]
        assert repr(meta[0]) == repr(meta[1]), kind


def test_converter_refuses_multiframe_color_ct(tmp_path):
    tdcm.dcmwrite(tmp_path / "dicom" / "bad.dcm",
                  {"Modality": "CT", "InstanceNumber": 1, "NumberOfFrames": 2, "Rows": 4,
                   "Columns": 4, "BitsAllocated": 8, "SamplesPerPixel": 3},
                  pixel_array=np.zeros((2, 4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="multi-frame color"):
        DicomConverter().convert(tmp_path / "dicom", tmp_path / "out", modality="CT")
    assert DicomConverter().convert(tmp_path / "none", tmp_path / "out") is None


def test_suv_formulas_match_jax():
    for t in ("083000", "083000.5", "0830", "235959.999"):
        assert tsuv.time_to_seconds(t) == jsuv.time_to_seconds(t)
    for args in (("080000", "094546.2", 6346.2), ("233000", "003000", 3600.0),
                 (None, "080000", 100.0), ("08x000", "090000", 100.0)):
        assert tsuv.decay_factor(*args) == jsuv.decay_factor(*args)
    for sex in ("M", "F"):
        for method in tsuv.SUV_METHODS:
            assert tsuv.suv_factor(method, 3.1e8, 72.0, 1.68, sex) == \
                jsuv.suv_factor(method, 3.1e8, 72.0, 1.68, sex)
        assert tsuv.lbm_james(200, 100, sex) == jsuv.lbm_james(200, 100, sex)
    for bad in (("bsa", 1e8, 70.0, None), ("xx", 1e8, 70.0, 1.7)):
        with pytest.raises(ValueError):
            tsuv.suv_factor(*bad)


def test_suv_calculator_matches_jax(tmp_path):
    pet = np.abs(_smooth_volume((8, 9, 6), 12)) * 1e4
    save_nifti(pet, tmp_path / "pet.nii.gz", affine=np.diag([4.0, 4.0, 3.0, 1.0]))
    np.save(tmp_path / "pet_metadata.npy", {
        "patient_sex": "F", "pet_info": {
            "patient_weight": 64.0, "patient_size": 1.62, "radionuclide_total_dose": 3.3e8,
            "radionuclide_half_life": 6586.2, "radiopharmaceutical_start_time": "081500",
            "acquisition_time": None, "series_time": "091000"}})
    cfg = {"analysis": {"suv": {"methods": list(tsuv.SUV_METHODS)}}}
    got = SUVCalculator(ConfigNode(cfg)).calculate(tmp_path, tmp_path / "port")
    want = jsuv.SUVCalculator(JConfig(cfg)).calculate(tmp_path, tmp_path / "jax")
    assert sorted(got) == sorted(want) == sorted(tsuv.SUV_METHODS)
    for m in got:
        assert _nifti_bytes(got[m]) == _nifti_bytes(want[m]), m
    mask = (pet > np.median(pet)).astype(np.float32)
    save_nifti(mask, tmp_path / "mask.nii.gz")
    for mask_path in (None, tmp_path / "mask.nii.gz"):
        assert SUVCalculator().get_suv_stats(got["bw"], mask_path) == \
            jsuv.SUVCalculator().get_suv_stats(want["bw"], mask_path)
    (tmp_path / "pet_metadata.npy").unlink()
    with pytest.raises(ValueError, match="metadata required"):
        SUVCalculator().calculate(tmp_path / "pet.nii.gz", tmp_path / "x")


def test_normalizer_matches_jax():
    img = np.random.default_rng(13).normal(100, 300, (8, 8, 8)).astype(np.float32)
    for modality, kwargs in (
            ("CT", {"window_center": -100, "window_width": 700}),
            ("PET", {"method": "max"}), ("PET", {"method": "percentile"}),
            ("PET", {"method": "reference", "reference_value": 2.5}),
            ("MRI", {"method": "zscore"}), ("MRI", {"method": "minmax"}),
            ("US", {"method": "minmax"}), ("US", {"method": "zscore"}), ("XX", {})):
        x = np.abs(img) if modality == "PET" else img
        got = IntensityNormalizer().normalize(x, modality, **kwargs)
        want = JNormalizer().normalize(x, modality, **kwargs)
        assert got.dtype == want.dtype == np.float32, (modality, kwargs)
        np.testing.assert_array_equal(got, want, err_msg=f"{modality} {kwargs}")


# --------------------------------------------------------------------------
# the whole mode
# --------------------------------------------------------------------------

STUDY_CT = ((40, 40, 24), (3.0, 3.0, 6.0))
STUDY_PET = ((20, 20, 18), (6.2, 6.2, 8.1))


def _preprocess_config(root: Path) -> Path:
    cfg = yaml.safe_load(Path(chip_smoke.PREP_CONFIG).read_text())
    cfg["experiment"]["log_dir"] = str(root / "logs")
    for mod in ("ct", "pet"):
        cfg["data"]["preprocessing"][mod]["target_spacing"] = [4.0, 4.0, 6.0]
    cfg["data"]["registration"].update(
        {"iterations": 3, "lr": 0.1, "shrink_factors": [1], "smoothing_sigmas": [0]})
    path = root / "preprocess.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_preprocess_mode_matches_the_jax_cli(tmp_path):
    """``--mode preprocess --device cpu`` on a small CT+PET study written by
    chip_smoke's study writer against the JAX CLI on the same study: every
    file the same, volumes within 1e-5 and the transform within 1e-3."""
    chip_smoke.write_study(tmp_path / "study", STUDY_CT, STUDY_PET, (8.0, -6.0, 12.0),
                           seed=3, device="cpu")
    config = _preprocess_config(tmp_path)
    args = ["--mode", "preprocess", "--config", str(config), "--input", str(tmp_path / "study")]
    jcli.main([*args, "--output", str(tmp_path / "jax")])
    cli.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert {str(f) for f in files} >= {
        "CT/ct.nii.gz", "CT/ct_metadata.npy", "PET/pet.nii.gz", "PET/pet_metadata.npy",
        "PET/pet_registered.nii.gz", "PET/pet_transform.json",
        *(f"PET/pet_suv_{m}.nii.gz" for m in tsuv.SUV_METHODS)}
    for f in files:
        want, got = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.name.endswith(".nii.gz"):
            (w, w_aff), (g, g_aff) = (load_nifti(p, return_affine=True) for p in (want, got))
            assert g.shape == w.shape, f
            np.testing.assert_array_equal(g_aff, w_aff)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=str(f))
        elif f.suffix == ".json":
            w, g = (json.loads(p.read_text()) for p in (want, got))
            assert (g["method"], g["metric"]) == (w["method"], w["metric"])
            np.testing.assert_allclose(g["params"]["t"], w["params"]["t"], rtol=0, atol=1e-3)
        else:
            assert repr(np.load(got, allow_pickle=True).item()) == \
                repr(np.load(want, allow_pickle=True).item())
    grid = tuple(int(round(n * s / t)) for n, s, t in zip(*STUDY_CT, (4.0, 4.0, 6.0)))
    assert load_nifti(tmp_path / "port" / "PET" / "pet_registered.nii.gz").shape == grid


def test_carried_shift_follows_the_resample_geometry():
    """``chip_smoke.carried_shift`` (the planted shift as the resampled grids
    carry it, the `[preprocess]` gate's reference) against the resample
    itself: a ramp equal to the physical x coordinate, resampled as the CLI
    does and put on the CT's grid through the affines; the translation that
    lines the two ramps up at the grid's centre is the carried shift."""
    ct, pet = ((512, 4, 4), (0.9766, 1.0, 1.0)), ((192, 4, 4), (4.0728, 1.0, 1.0))
    target, shift = (1.5, 1.0, 1.0), (4.2, 0.0, 0.0)
    grids = []
    for (shape, spacing), d in ((ct, 0.0), (pet, shift[0])):
        origin = chip_smoke.study_origin(shape, spacing)
        x = origin[0] + np.arange(shape[0]) * spacing[0] - d
        affine = np.diag([*spacing, 1.0])
        affine[:3, 3] = origin
        vol = np.broadcast_to(x[:, None, None], shape).astype(np.float32)
        grids.append(resample_volume(vol, affine, target, device="cpu"))
    (ct_vol, ct_aff), (pet_vol, pet_aff) = grids
    on_ct = ImageRegistration.resample_to_fixed_grid(pet_vol, pet_aff, ct_vol.shape, ct_aff,
                                                     device="cpu")[:, 1, 1]
    i = (ct_vol.shape[0] - 1) // 2
    slope = np.polyfit(np.arange(i - 20, i + 20), on_ct[i - 20:i + 20], 1)[0]
    t = (ct_vol[i, 1, 1] - on_ct[i]) / slope
    want = chip_smoke.carried_shift(ct, pet, target, shift)[0]
    centre = (ct_vol.shape[0] - 1) / 2
    # carried_shift is taken at the centre, i here; the shift drifts by
    # (r_ct / r_pet - 1) voxel a voxel, r the true spacing of a resampled grid
    r_ct, r_pet = 511 * 0.9766 / 332, 191 * 4.0728 / 520
    drift = (r_ct / r_pet - 1) * (i - centre)
    assert abs(t - (want + drift)) < 1e-3, (t, want + drift)
    assert abs(want - shift[0] / target[0]) > 0.5  # the grids move it by more than half a voxel
