"""Histogram analysis figures (port of the JAX package's ``analysis/histogram.py``).

Per-organ SUV histograms in a 2×4 grid with mean/median lines; a combined
density histogram; threshold-vs-volume curves (relative %-of-max over 50
steps and absolute SUV 0–20); per-organ CDFs; a fixed per-organ palette. The
organs' values are gathered on the analyzer's device; the figures are drawn
on the host (matplotlib, imported when a figure is drawn).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from multimodal_organ_segmentation_tpu_torch.analysis.suv import (
    ORGAN_LABELS,
    Device,
    analysis_device,
    find_file,
    load_seg,
    load_suv,
)
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir

ORGAN_COLORS = {
    "bladder": "#1f77b4",
    "kidney_right": "#ff7f0e",
    "kidney_left": "#2ca02c",
    "heart": "#d62728",
    "liver": "#9467bd",
    "spleen": "#8c564b",
    "brain": "#e377c2",
}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def organ_values(suv, seg, labels: Dict[int, str] = ORGAN_LABELS) -> Dict[str, np.ndarray]:
    """Each present organ's SUV values (tensors on any device) as host arrays."""
    out = {}
    for lid, name in labels.items():
        vals = suv[seg == lid]
        if vals.numel():
            out[name] = vals.cpu().numpy()
    return out


class HistogramAnalyzer:
    """SUV distribution figures per organ."""

    def __init__(self, config=None, device: Device = None):
        self.config = config
        self.device = analysis_device(device)
        hist_cfg = (config.get("analysis.histogram", {}) or {}) if config is not None else {}
        self.bins = int(hist_cfg.get("bins", 100))

    def analyze(self, input_path, output_path) -> Dict[str, Any]:
        input_path = Path(input_path)
        output_path = ensure_dir(output_path)

        suv_file = find_file(input_path, ["*suv*.nii*", "*SUV*.nii*", "*pet*.nii*"])
        seg_file = find_file(input_path, ["*seg*.nii*", "*label*.nii*", "*pred*.nii*"])
        if suv_file is None or seg_file is None:
            raise FileNotFoundError("SUV or segmentation file not found")

        suv, _, _ = load_suv(suv_file, self.device)
        values = organ_values(suv, load_seg(seg_file, self.device))
        written: List[str] = [
            self.plot_organ_histograms(values, output_path),
            self.plot_combined_histogram(values, output_path),
            self.plot_threshold_curves(values, output_path),
            self.plot_cdf(values, output_path),
        ]
        return {"figures": [w for w in written if w], "organs": list(values)}

    # -- figures -----------------------------------------------------------

    def plot_organ_histograms(self, organ_values, output_path) -> str:
        plt = _pyplot()
        fig, axes = plt.subplots(2, 4, figsize=(18, 8))
        axes = axes.ravel()
        for ax, (organ, vals) in zip(axes, organ_values.items()):
            color = ORGAN_COLORS.get(organ, "gray")
            ax.hist(vals, bins=self.bins, color=color, alpha=0.7)
            ax.axvline(np.mean(vals), color="red", linestyle="--", label="mean")
            ax.axvline(np.median(vals), color="black", linestyle=":", label="median")
            ax.set_title(organ)
            ax.set_xlabel("SUV")
            ax.legend(fontsize=7)
        for ax in axes[len(organ_values):]:
            ax.axis("off")
        fig.tight_layout()
        out = str(Path(output_path) / "organ_histograms.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def plot_combined_histogram(self, organ_values, output_path) -> str:
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(10, 6))
        for organ, vals in organ_values.items():
            ax.hist(vals, bins=self.bins, density=True, histtype="step", label=organ,
                    color=ORGAN_COLORS.get(organ, "gray"))
        ax.set_xlabel("SUV")
        ax.set_ylabel("density")
        ax.legend()
        fig.tight_layout()
        out = str(Path(output_path) / "combined_histogram.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def plot_threshold_curves(self, organ_values, output_path) -> str:
        plt = _pyplot()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
        rel = np.linspace(0, 1, 50)
        for organ, vals in organ_values.items():
            color = ORGAN_COLORS.get(organ, "gray")
            mx = np.max(vals) if len(vals) else 1.0
            ax1.plot(rel * 100, [(vals >= mx * t).sum() for t in rel], label=organ, color=color)
            abs_t = np.linspace(0, 20, 50)
            ax2.plot(abs_t, [(vals >= t).sum() for t in abs_t], label=organ, color=color)
        ax1.set_xlabel("threshold (% of max)")
        ax1.set_ylabel("volume (voxels)")
        ax1.set_title("relative threshold vs volume")
        ax2.set_xlabel("SUV threshold")
        ax2.set_title("absolute threshold vs volume")
        ax1.legend(fontsize=7)
        fig.tight_layout()
        out = str(Path(output_path) / "threshold_curves.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def plot_cdf(self, organ_values, output_path) -> str:
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(10, 6))
        for organ, vals in organ_values.items():
            v = np.sort(vals)
            ax.plot(v, np.arange(1, len(v) + 1) / len(v), label=organ,
                    color=ORGAN_COLORS.get(organ, "gray"))
        ax.set_xlabel("SUV")
        ax.set_ylabel("CDF")
        ax.legend(fontsize=8)
        fig.tight_layout()
        out = str(Path(output_path) / "organ_cdf.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out
