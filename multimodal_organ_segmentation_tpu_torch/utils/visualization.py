"""Visualization helpers (port of the JAX package's ``utils/visualization.py``).

The same surface: 8-label colour and name maps, ``plot_slice`` (any axis),
``plot_multimodal`` side by side, ``plot_segmentation`` (3-panel overlay with
RGB label blending), ``plot_training_curves``, ``plot_confusion_matrix``, and
a static ``create_montage`` grid. matplotlib is imported when a figure is
drawn, so the package imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Visualizer:
    """Figure helpers for volumes, segmentations, and training curves."""

    LABEL_COLORS = {
        0: (0.0, 0.0, 0.0),       # background
        1: (1.0, 0.8, 0.0),       # bladder
        2: (0.0, 0.6, 1.0),       # kidney_right
        3: (0.0, 0.8, 0.6),       # kidney_left
        4: (1.0, 0.2, 0.2),       # heart
        5: (0.6, 0.3, 0.1),       # liver
        6: (0.7, 0.1, 0.7),       # spleen
        7: (1.0, 0.5, 0.8),       # brain
    }
    LABEL_NAMES = {
        0: "background",
        1: "bladder",
        2: "kidney_right",
        3: "kidney_left",
        4: "heart",
        5: "liver",
        6: "spleen",
        7: "brain",
    }

    def __init__(self, output_dir=None):
        self.output_dir = Path(output_dir) if output_dir else None

    def _finish(self, fig, save_path):
        plt = _pyplot()
        if save_path is not None:
            p = Path(save_path)
            if self.output_dir and not p.is_absolute():
                p = self.output_dir / p
            p.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(p, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return str(p)
        return fig

    @staticmethod
    def _get_slice(volume: np.ndarray, axis: int, idx: Optional[int]) -> np.ndarray:
        if idx is None:
            idx = volume.shape[axis] // 2
        return np.take(volume, idx, axis=axis)

    def plot_slice(
        self, volume, axis: int = 2, slice_idx: Optional[int] = None,
        cmap: str = "gray", title: Optional[str] = None, save_path=None,
    ):
        plt = _pyplot()
        sl = self._get_slice(np.asarray(volume), axis, slice_idx)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(sl.T, cmap=cmap, origin="lower")
        if title:
            ax.set_title(title)
        ax.axis("off")
        return self._finish(fig, save_path)

    def plot_multimodal(
        self, volumes: Dict[str, np.ndarray], axis: int = 2,
        slice_idx: Optional[int] = None, save_path=None,
    ):
        plt = _pyplot()
        n = len(volumes)
        fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
        axes = np.atleast_1d(axes)
        for ax, (name, vol) in zip(axes, volumes.items()):
            sl = self._get_slice(np.asarray(vol), axis, slice_idx)
            ax.imshow(sl.T, cmap="gray", origin="lower")
            ax.set_title(name)
            ax.axis("off")
        return self._finish(fig, save_path)

    def label_to_rgb(self, label_slice: np.ndarray) -> np.ndarray:
        rgb = np.zeros((*label_slice.shape, 3), dtype=np.float32)
        for lid, color in self.LABEL_COLORS.items():
            rgb[label_slice == lid] = color
        return rgb

    def plot_segmentation(
        self, image, label, axis: int = 2, slice_idx: Optional[int] = None,
        alpha: float = 0.4, save_path=None,
    ):
        """3-panel: image | labels | overlay."""
        plt = _pyplot()
        img_sl = self._get_slice(np.asarray(image), axis, slice_idx)
        lbl_sl = self._get_slice(np.asarray(label), axis, slice_idx)
        rgb = self.label_to_rgb(lbl_sl)

        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(img_sl.T, cmap="gray", origin="lower")
        axes[0].set_title("image")
        axes[1].imshow(rgb.transpose(1, 0, 2), origin="lower")
        axes[1].set_title("segmentation")
        axes[2].imshow(img_sl.T, cmap="gray", origin="lower")
        mask = lbl_sl.T > 0
        overlay = np.zeros((*img_sl.T.shape, 4))
        overlay[..., :3] = rgb.transpose(1, 0, 2)
        overlay[..., 3] = mask * alpha
        axes[2].imshow(overlay, origin="lower")
        axes[2].set_title("overlay")
        for ax in axes:
            ax.axis("off")
        return self._finish(fig, save_path)

    def plot_training_curves(self, history: Dict[str, List[float]], save_path=None):
        plt = _pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        if "train_loss" in history:
            axes[0].plot(history["train_loss"], label="train")
        if "val_loss" in history:
            axes[0].plot(history["val_loss"], label="val")
        axes[0].set_xlabel("epoch")
        axes[0].set_ylabel("loss")
        axes[0].legend()
        if "val_dice" in history:
            axes[1].plot(history["val_dice"], label="val dice", color="green")
            axes[1].set_xlabel("epoch")
            axes[1].set_ylabel("dice")
            axes[1].legend()
        return self._finish(fig, save_path)

    def plot_confusion_matrix(
        self, matrix, class_names: Optional[Sequence[str]] = None,
        normalize: bool = True, save_path=None,
    ):
        plt = _pyplot()
        m = np.asarray(matrix, dtype=np.float64)
        if normalize:
            m = m / (m.sum(axis=1, keepdims=True) + 1e-8)
        n = m.shape[0]
        names = class_names or [self.LABEL_NAMES.get(i, str(i)) for i in range(n)]
        fig, ax = plt.subplots(figsize=(8, 7))
        im = ax.imshow(m, cmap="Blues")
        fig.colorbar(im, ax=ax)
        ax.set_xticks(range(n))
        ax.set_yticks(range(n))
        ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
        ax.set_yticklabels(names, fontsize=7)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        for i in range(n):
            for j in range(n):
                ax.text(j, i, f"{m[i, j]:.2f}", ha="center", va="center", fontsize=6)
        return self._finish(fig, save_path)

    @staticmethod
    def create_montage(
        volume: np.ndarray, axis: int = 2, n_slices: int = 16,
        cols: int = 4,
    ) -> np.ndarray:
        """Grid of evenly spaced slices."""
        vol = np.asarray(volume)
        total = vol.shape[axis]
        idxs = np.linspace(0, total - 1, n_slices).astype(int)
        slices = [np.take(vol, i, axis=axis) for i in idxs]
        rows = (n_slices + cols - 1) // cols
        h, w = slices[0].shape
        montage = np.zeros((rows * h, cols * w), dtype=vol.dtype)
        for k, sl in enumerate(slices):
            r, c = divmod(k, cols)
            montage[r * h : (r + 1) * h, c * w : (c + 1) * w] = sl
        return montage
