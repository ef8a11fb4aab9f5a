"""The port's analysis tail (SUV, TMTV/TLG, histograms, reports, the XLSX
writer) against the JAX package's, on the CPU.

The same NIfTI files go through both. The port's statistics run on tensors
(here on the CPU); the JAX package's on numpy, both in float64: the numbers
agree within 1e-6 relative, the masks exactly, and the tables have the same
columns and rows.

The case has every organ branch: a liver (label 5) with an even voxel
count, so that the median averages the two middle values; a heart with an
odd count; a hot tumour outside the organs whose maximum is tied at two
voxels, so that SUVpeak must take the first in C order; and a region of an
unknown label (9), which counts as tumour region.
"""

import csv
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_organ_segmentation_tpu import analysis as janalysis
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch import analysis
from multimodal_organ_segmentation_tpu_torch.analysis.suv import median, std
from multimodal_organ_segmentation_tpu_torch.analysis.tmtv import TMTVAnalyzer
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from multimodal_organ_segmentation_tpu_torch.utils.visualization import Visualizer
from multimodal_organ_segmentation_tpu_torch.utils.xlsx import records_table, write_xlsx
from tests.torch_port_utils import _one_thread  # noqa: F401

REL = 1e-6
CFG = {"analysis": {"tmtv": {"absolute_threshold": 2.5, "percentage_threshold": 0.4},
                    "histogram": {"bins": 20}}}


def _case(root: Path, liver: bool = True, seg: bool = True) -> Path:
    rng = np.random.default_rng(0)
    shape = (24, 22, 20)
    suv = rng.uniform(0.2, 0.8, shape).astype(np.float32)
    lab = np.zeros(shape, np.uint8)
    if liver:
        lab[2:8, 2:8, 2:8] = 5  # 216 voxels: an even count
        suv[2:8, 2:8, 2:8] = rng.normal(2.0, 0.3, (6, 6, 6))
    lab[10:13, 10:13, 10:13] = 4  # 27 voxels: an odd count
    suv[10:13, 10:13, 10:13] = rng.normal(1.5, 0.1, (3, 3, 3))
    suv[16:21, 15:20, 12:17] = rng.normal(6.0, 0.5, (5, 5, 5))  # hot, outside the organs
    suv[18, 17, 14] = suv[19, 16, 13] = 9.5  # the maximum, tied at two voxels
    lab[0:3, 18:22, 0:4] = 9  # an unknown label: tumour region
    suv[0:3, 18:22, 0:4] = 3.0
    root.mkdir(parents=True, exist_ok=True)
    affine = np.diag([2.0, 1.5, 2.5, 1.0])
    save_nifti(suv, root / "pet_suv_bw.nii.gz", affine=affine)
    if seg:
        save_nifti(lab, root / "pred_seg.nii.gz", affine=affine)
    return root


def _close(a, b, path=""):
    """Nested results equal: the same keys in the same order, numbers within
    1e-6 relative, strings equal."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, str):
        assert a == b, path
    else:
        assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
        assert b == pytest.approx(a, rel=REL, abs=1e-12), path


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _csv_close(ref_rows, rows):
    assert rows[0] == ref_rows[0]  # the same columns in the same order
    assert len(rows) == len(ref_rows)
    for r, o in zip(ref_rows[1:], rows[1:]):
        for x, y in zip(r, o):
            try:
                assert float(y) == pytest.approx(float(x), rel=REL, abs=1e-12)
            except ValueError:
                assert x == y


def _xlsx_rows(path):
    with zipfile.ZipFile(path) as z:
        sheet = z.read("xl/worksheets/sheet1.xml").decode()
    return sheet.count("<row "), sheet


def _cells(sheet):
    """The sheet's cells in order: numbers as floats, text as it is."""
    import re

    cells = []
    for m in re.finditer(r'<c r="[A-Z]+\d+"( t="(\w+)")?>(.*?)</c>', sheet):
        kind, body = m.group(2), m.group(3)
        text = re.sub(r"<[^>]+>", "", body)
        cells.append(text if kind == "inlineStr" else float(text))
    return cells


@pytest.mark.parametrize("variant", ["full", "no_liver", "no_seg"])
def test_analyzers_match_jax(tmp_path, variant):
    case = _case(tmp_path / "case", liver=variant != "no_liver", seg=variant != "no_seg")
    jcfg, cfg = JConfig(CFG), ConfigNode(CFG)
    jout, out = tmp_path / "jax", tmp_path / "port"
    if variant != "no_seg":
        _close(janalysis.SUVAnalyzer(jcfg).analyze(case, jout),
               analysis.SUVAnalyzer(cfg, "cpu").analyze(case, out))
        _csv_close(_read_csv(jout / "suv_analysis.csv"), _read_csv(out / "suv_analysis.csv"))
        _close(janalysis.SUVAnalyzer(jcfg).analyze_tumor(case / "pet_suv_bw.nii.gz",
                                                         case / "pred_seg.nii.gz"),
               analysis.SUVAnalyzer(cfg, "cpu").analyze_tumor(case / "pet_suv_bw.nii.gz",
                                                              case / "pred_seg.nii.gz"))
    ref = janalysis.TMTVAnalyzer(jcfg).analyze(case, jout)
    res = TMTVAnalyzer(cfg, "cpu").analyze(case, out)
    _close(ref, res)
    _csv_close(_read_csv(jout / "tmtv_analysis.csv"), _read_csv(out / "tmtv_analysis.csv"))
    masks = ["tmtv_absolute", "tmtv_percentage"] + (["tmtv_liver_based"] if variant != "no_seg"
                                                    else [])
    for name in masks:
        np.testing.assert_array_equal(load_nifti(out / f"{name}.nii.gz"),
                                      load_nifti(jout / f"{name}.nii.gz"))
    for table in ("tmtv_analysis",) + (("suv_analysis",) if variant != "no_seg" else ()):
        n, sheet = _xlsx_rows(out / f"{table}.xlsx")
        jn, jsheet = _xlsx_rows(jout / f"{table}.xlsx")
        assert n == jn and _cells(sheet) == pytest.approx(_cells(jsheet), rel=REL)


def test_the_case_has_ties_and_an_even_median(tmp_path):
    """The case exercises what it claims: SUVpeak's tie at the maximum
    (the first in C order), the even-count median (torch's own median would
    take the lower middle value) and numpy's std (ddof 0)."""
    case = _case(tmp_path)
    suv = torch.from_numpy(load_nifti(case / "pet_suv_bw.nii.gz", dtype=np.float64))
    seg = torch.from_numpy(load_nifti(case / "pred_seg.nii.gz").astype(np.int32))
    liver = suv[seg == 5]
    assert liver.numel() % 2 == 0
    assert float(median(liver)) == float(np.median(liver.numpy()))
    assert float(median(liver)) != float(torch.median(liver))
    assert float(std(liver)) == pytest.approx(float(np.std(liver.numpy())), rel=1e-12)
    tm = TMTVAnalyzer(ConfigNode(CFG), "cpu")
    mask = (suv >= 2.5) & ((seg == 0) | (seg > 7))
    assert int((suv[mask] == suv[mask].max()).sum()) == 2
    ref = janalysis.TMTVAnalyzer(JConfig(CFG)).suv_peak(suv.numpy(), mask.numpy())
    assert tm.suv_peak(suv, mask) == pytest.approx(ref, rel=REL)


def test_histogram_and_report_match_jax(tmp_path):
    case = _case(tmp_path / "case")
    jout, out = tmp_path / "jax", tmp_path / "port"
    ref = janalysis.HistogramAnalyzer(JConfig(CFG)).analyze(case, jout)
    res = analysis.HistogramAnalyzer(ConfigNode(CFG), "cpu").analyze(case, out)
    assert res["organs"] == ref["organs"] == ["heart", "liver"]
    assert [Path(f).name for f in res["figures"]] == [Path(f).name for f in ref["figures"]]
    assert all(Path(f).stat().st_size > 1000 for f in res["figures"])
    results = {"suv": analysis.SUVAnalyzer(None, "cpu").analyze(case, out),
               "tmtv": TMTVAnalyzer(None, "cpu").analyze(case, out), "histogram": res}
    written = analysis.ReportGenerator().generate(results, out)
    jwritten = janalysis.ReportGenerator().generate(results, jout)
    assert sorted(written) == sorted(jwritten) == ["docx", "html", "markdown"]
    md = Path(written["markdown"]).read_text().splitlines()
    jmd = Path(jwritten["markdown"]).read_text().splitlines()
    assert [ln for ln in md if not ln.startswith("Generated")] == [
        ln for ln in jmd if not ln.startswith("Generated")]
    with zipfile.ZipFile(written["docx"]) as z:
        assert "word/document.xml" in z.namelist()
        assert "TMTV" in z.read("word/document.xml").decode()
    assert "<table>" in Path(written["html"]).read_text()


def test_records_table_holds_what_a_dataframe_of_the_rows_holds(tmp_path):
    """Columns by first appearance; a column of numbers with a float or a
    missing value is all floats; missing values NaN (empty in the CSV)."""
    import pandas as pd

    records = [{"metric": "a", "v": 0, "x": 1.5}, {"metric": "b", "v": 2.0, "s": "err"},
               {"metric": "c", "v": 3, "x": 2, "n": 5}]
    columns, rows = records_table(records)
    df = pd.DataFrame(records)
    assert columns == list(df.columns)
    for got, want in zip(rows, df.values.tolist()):
        for g, w in zip(got, want):
            assert (g != g and w != w) or (g == w and type(g) is type(w)), (got, want)
    write_xlsx([columns] + rows, tmp_path / "t.xlsx")
    with zipfile.ZipFile(tmp_path / "t.xlsx") as z:
        assert z.read("xl/worksheets/sheet1.xml").decode().count("<row ") == 4


def test_analyzers_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (analysis.SUVAnalyzer, analysis.TMTVAnalyzer, analysis.HistogramAnalyzer):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(None)


def test_visualizer_figures(tmp_path):
    viz = Visualizer(tmp_path)
    rng = np.random.default_rng(0)
    vol, lab = rng.random((8, 8, 8)), rng.integers(0, 8, (8, 8, 8))
    out = [viz.plot_slice(vol, save_path="slice.png"),
           viz.plot_multimodal({"ct": vol, "pet": vol}, save_path="mm.png"),
           viz.plot_segmentation(vol, lab, save_path="seg.png"),
           viz.plot_training_curves({"train_loss": [1, 0.5], "val_dice": [0.2, 0.4]},
                                    save_path="curves.png"),
           viz.plot_confusion_matrix(np.eye(3) + 1, save_path="cm.png")]
    assert all(Path(p).stat().st_size > 1000 for p in out)
    montage = Visualizer.create_montage(vol, n_slices=4, cols=2)
    assert montage.shape == (16, 16)
