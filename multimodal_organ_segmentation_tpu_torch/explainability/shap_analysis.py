"""Gradient SHAP and integrated gradients (port of the JAX package's
``explainability/shap_analysis.py``).

- gradient SHAP: grad × (input − baseline), the baseline the per-channel
  mean of the input ("background") or zeros;
- integrated gradients along the straight path with the midpoint rule,
  α_k = (k + ½)/n, whose Σ attributions ≈ F(x) − F(baseline) more closely
  than the left endpoints; the n gradients run one after another and sum in
  f32, as the JAX package's ``lax.scan``;
- per-channel importance and a slice figure.

The gradient is ``torch.autograd.grad`` of the summed class logits with
respect to the input (no parameter's ``.grad`` changes); on the card kernels
A and B run in each forward and their custom ops' gradients in the backward.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import logits_of, on_device
from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import sliding_window_inference


class SHAPAnalyzer:
    """Input-attribution maps for a segmentation model."""

    def __init__(self, model: nn.Module, n_steps: int = 50):
        self.model = model
        self.n_steps = n_steps

    def _grad(self, x: torch.Tensor, class_idx: int) -> torch.Tensor:
        """d Σ logits[..., class_idx] / d x. A batch of independent samples
        (tiles) gives each sample's own gradient."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            score = logits_of(self.model(xg))[..., class_idx].sum()
            (g,) = torch.autograd.grad(score, xg)
        return g

    @staticmethod
    def _baseline(x: torch.Tensor, kind: str = "background") -> torch.Tensor:
        if kind == "zeros":
            return torch.zeros_like(x)
        return x.mean(dim=(1, 2, 3), keepdim=True).expand_as(x)  # per-sample channel mean

    def _integrated(self, x: torch.Tensor, baseline: torch.Tensor, class_idx: int) -> torch.Tensor:
        total = torch.zeros_like(x)
        for k in range(self.n_steps):
            alpha = (k + 0.5) / self.n_steps
            total += self._grad(baseline + alpha * (x - baseline), class_idx)
        return (x - baseline) * total / self.n_steps

    def gradient_shap(self, x, class_idx: int = 1, baseline: str = "background") -> np.ndarray:
        """grad × (input − baseline) attribution ``[B, H, W, D, C]``."""
        x = on_device(x, self.model)
        return (self._grad(x, class_idx) * (x - self._baseline(x, baseline))).cpu().numpy()

    def integrated_gradients(self, x, class_idx: int = 1,
                             baseline: str = "background") -> np.ndarray:
        x = on_device(x, self.model)
        return self._integrated(x, self._baseline(x, baseline), class_idx).cpu().numpy()

    # ---- native-grid integrated gradients through the sliding window ----

    def integrated_gradients_native(
        self,
        volume,
        class_idx: int = 1,
        *,
        roi_size,
        overlap: float = 0.5,
        sw_batch_size: int = 4,
        mode: str = "gaussian",
        baseline: str = "background",
    ) -> np.ndarray:
        """Signed IG attributions ``[H, W, D, C]`` on the native grid of
        ``volume`` ``[H, W, D, C]``: each tile's IG (its baseline the tile's
        own channel mean), Gaussian-blended as logits are. A volume within
        the ROI is one tile and equals :meth:`integrated_gradients`."""
        volume = on_device(volume, self.model)
        blended = sliding_window_inference(
            volume,
            lambda patches: self._integrated(patches, self._baseline(patches, baseline), class_idx),
            roi_size=tuple(roi_size), num_classes=int(volume.shape[-1]), overlap=overlap,
            sw_batch_size=sw_batch_size, mode=mode,
        )
        return blended.cpu().numpy()

    @staticmethod
    def channel_importance(attribution: np.ndarray) -> np.ndarray:
        """Mean |attribution| per input channel (modality importance)."""
        return np.abs(attribution).mean(axis=tuple(range(attribution.ndim - 1)))

    def visualize(self, image, attribution: np.ndarray, output_path, axis: int = 2,
                  slice_idx: Optional[int] = None) -> str:
        """Slice view of the attributions per channel + importance bars."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        image = image.float().cpu().numpy() if torch.is_tensor(image) else np.asarray(image)
        attr = np.asarray(attribution)
        if image.ndim == 5:
            image, attr = image[0], attr[0]
        n_ch = image.shape[-1]
        if slice_idx is None:
            slice_idx = image.shape[axis] // 2

        fig, axes = plt.subplots(2, n_ch + 1, figsize=(5 * (n_ch + 1), 9))
        for c in range(n_ch):
            img_sl = np.take(image[..., c], slice_idx, axis=axis)
            at_sl = np.take(attr[..., c], slice_idx, axis=axis)
            axes[0, c].imshow(img_sl.T, cmap="gray", origin="lower")
            axes[0, c].set_title(f"channel {c}")
            vmax = np.abs(at_sl).max() + 1e-8
            axes[1, c].imshow(at_sl.T, cmap="bwr", vmin=-vmax, vmax=vmax, origin="lower")
            axes[1, c].set_title(f"attribution {c}")
        for row in axes:
            for ax in row[:-1]:
                ax.axis("off")
        imp = self.channel_importance(attr)
        axes[0, n_ch].bar(range(n_ch), imp)
        axes[0, n_ch].set_title("channel importance")
        axes[1, n_ch].axis("off")
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(output_path, dpi=100)
        plt.close(fig)
        return str(output_path)
