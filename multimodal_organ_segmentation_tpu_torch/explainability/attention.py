"""Attention maps (port of the JAX package's ``explainability/attention.py``).

Collects the attention tensors the model sows (``forward``'s
``intermediates``: each window attention's probabilities, the
``AttentionFusion`` modality weights) under the names flax gives them
(``backbone/stage0_block0/attn/attn_probs/[0]``, ...), in flax's flatten
order, reduces them to spatial saliency maps and renders 3-plane heatmaps
and an all-heads grid.

A window attention hands its probabilities out only on its dense path: the
capture forward takes that path for kernel A, as the flax module does under
capture, while the fusion attention still runs kernel B on the card.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import (
    PREFIX,
    minmax,
    on_device,
)
from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import SwinBlock
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import sliding_window_inference


def _flat_name(path: Tuple[str, ...], index: int) -> str:
    """flax's name of the ``index``-th value sown at ``path`` (a sown value
    is a tuple, whose flatten key prints as ``[i]``)."""
    return PREFIX + "/".join(path) + f"/[{index}]"


class AttentionVisualizer:
    """Collects and renders attention maps."""

    def __init__(self, model: nn.Module):
        self.model = model

    @torch.no_grad()
    def _sown(self, x: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        """(name, tensor) of every sown value of a forward on ``x``, in
        flax's flatten order (dict keys sorted at every level)."""
        intermediates: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        self.model(x, intermediates=intermediates)
        return [(_flat_name(path, i), v) for path in sorted(intermediates)
                for i, v in enumerate(intermediates[path])]

    def capture(self, x) -> Dict[str, np.ndarray]:
        """Run a forward pass collecting all sown attention tensors."""
        return {name: v.float().cpu().numpy() for name, v in self._sown(on_device(x, self.model))}

    @staticmethod
    def attention_rollout(attn: np.ndarray) -> np.ndarray:
        """[B', heads, N, N] window attention → per-token saliency [B', N]:
        mean over heads of attention received (column mean)."""
        return attn.mean(axis=1).mean(axis=1)

    def _window_grid(self, nw: int, spatial: Tuple[int, int, int]) -> Optional[Tuple[int, int, int]]:
        """Per-axis window counts ``(nw_h, nw_w, nw_d)`` with product ``nw``,
        from the model's ``window_size`` and the input's spatial dims over
        the downsample levels /2 (patch embedding) to /64, so an anisotropic
        grid whose product is a perfect cube folds on its own axes. When two
        levels give different grids of the same product the fold is
        ambiguous and there is none (None). Without a window size: a cube
        grid, or None."""
        grids = {cnt for cnt in self._level_grids(spatial) if np.prod(cnt) == nw}
        if len(grids) == 1:
            return grids.pop()
        if grids:
            return None
        side = round(nw ** (1 / 3))
        return (side, side, side) if side**3 == nw else None

    def _level_grids(self, spatial: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
        """The window counts per axis of ``spatial`` at /2 ... /64 (none
        without a ``window_size`` on the model)."""
        ws = getattr(self.model, "window_size", None)
        if ws is None:
            return []
        grids = []
        for k in range(1, 7):
            dims = [max(1, -(-int(s) // (2**k))) for s in spatial]
            grids.append(tuple(-(-d // int(w)) for d, w in zip(dims, ws)))
        return grids

    def spatial_map(self, attn: np.ndarray, volume_shape: Tuple[int, int, int]) -> Optional[np.ndarray]:
        """Fold window-token saliency back onto the window grid, resized to
        ``volume_shape`` and minmax-normalised; None where it does not fold."""
        if attn.ndim != 4:
            return None
        per_window = self.attention_rollout(attn).mean(axis=1)  # [B·nW]
        counts = self._window_grid(per_window.shape[0], tuple(volume_shape))
        if counts is None:
            return None
        grid = torch.from_numpy(np.ascontiguousarray(per_window.reshape(counts)))
        vol = resize_linear(grid, tuple(volume_shape), (0, 1, 2)).numpy()
        lo, hi = vol.min(), vol.max()
        return (vol - lo) / (hi - lo + 1e-8)

    # ---- native-grid saliency through the sliding window ----

    def _foldable(self, roi: Tuple[int, int, int], max_layers: int) -> int:
        """How many ``attn_probs`` tensors of a tile fold (at most
        ``max_layers``), from each Swin block's windows per tile, without a
        forward (flax's ``eval_shape`` probe)."""
        windows = [int(np.prod([-(-g // w) for g, w in zip(m.grid, m.window)]))
                   for m in self.model.modules() if isinstance(m, SwinBlock)]
        return min(max_layers, sum(self._window_grid(nw, roi) is not None for nw in windows))

    def _tile_saliency(self, patches: torch.Tensor, max_layers: int) -> torch.Tensor:
        """Per-tile saliency ``[n, *roi, L]``: as :meth:`spatial_map` per
        tile, unnormalised, so the tiles share one minmax after the blend."""
        n, roi = patches.shape[0], tuple(patches.shape[1:4])
        vols = []
        for name, attn in self._sown(patches):
            if len(vols) >= max_layers:
                break
            if "attn_probs" not in name or attn.dim() != 4:
                continue
            counts = self._window_grid(attn.shape[0] // n, roi)
            if counts is None:
                continue
            per_window = attn.float().mean(dim=(1, 2)).mean(dim=1).reshape(n, *counts)
            vols.append(resize_linear(per_window, roi, (1, 2, 3)))
        if not vols:
            raise ValueError("no foldable attn_probs tensors (window grid unresolvable)")
        return torch.stack(vols, dim=-1)

    def saliency_native(
        self,
        volume,
        *,
        roi_size: Tuple[int, int, int],
        overlap: float = 0.5,
        sw_batch_size: int = 4,
        mode: str = "gaussian",
        max_layers: int = 4,
    ) -> List[np.ndarray]:
        """Up to ``max_layers`` attention saliency volumes ``[H, W, D]`` on
        the native grid of ``volume`` ``[H, W, D, C]``, through the tile
        grid and Gaussian blend of logits inference, each minmax-normalised."""
        roi = tuple(int(r) for r in roi_size)
        n_layers = self._foldable(roi, max_layers)
        if n_layers == 0:
            raise ValueError("no foldable attn_probs tensors (window grid unresolvable)")
        blended = sliding_window_inference(
            on_device(volume, self.model),
            lambda patches: self._tile_saliency(patches, max_layers),
            roi_size=roi, num_classes=n_layers, overlap=overlap, sw_batch_size=sw_batch_size,
            mode=mode,
        )
        return [minmax(blended[..., i]).cpu().numpy() for i in range(n_layers)]

    def visualize(self, x, output_dir, max_layers: int = 4) -> List[str]:
        """Write 3-plane heatmaps for up to ``max_layers`` attention maps and
        the all-heads grid of the first."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        captured = self.capture(x)
        x = x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        vol_shape = x.shape[1:4]

        written = []
        count = 0
        for name, attn in captured.items():
            if count >= max_layers:
                break
            if "attn_probs" not in name:
                continue
            spatial = self.spatial_map(attn, vol_shape)
            if spatial is None:
                continue
            img = x[0, ..., 0]
            fig, axes = plt.subplots(1, 3, figsize=(15, 5))
            for ax, axis_idx, title in zip(axes, (2, 1, 0), ("axial", "coronal", "sagittal")):
                mid = img.shape[axis_idx] // 2
                ax.imshow(np.take(img, mid, axis=axis_idx).T, cmap="gray", origin="lower")
                ax.imshow(np.take(spatial, mid, axis=axis_idx).T, cmap="jet", alpha=0.4,
                          origin="lower")
                ax.set_title(f"{title}")
                ax.axis("off")
            safe = name.replace("/", "_")[:80]
            out = output_dir / f"attention_{count}_{safe}.png"
            fig.suptitle(name, fontsize=8)
            fig.tight_layout()
            fig.savefig(out, dpi=100)
            plt.close(fig)
            written.append(str(out))
            count += 1

        first = next((a for n, a in captured.items() if "attn_probs" in n), None)
        if first is not None and first.ndim == 4:
            heads = first.shape[1]
            cols = min(heads, 4)
            rows = (heads + cols - 1) // cols
            fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
            axes = np.atleast_1d(axes).ravel()
            for h in range(heads):
                axes[h].imshow(first[0, h], cmap="viridis")
                axes[h].set_title(f"head {h}")
                axes[h].axis("off")
            for ax in axes[heads:]:
                ax.axis("off")
            out = output_dir / "attention_heads_grid.png"
            fig.tight_layout()
            fig.savefig(out, dpi=100)
            plt.close(fig)
            written.append(str(out))
        return written
