"""t-SNE of pooled encoder features (port of the JAX package's
``explainability/tsne.py``).

The capture features of one level, mean-pooled over space, come from the
model's device; the labels are each sample's most frequent foreground label;
the embedding is sklearn's ``TSNE`` on the host (perplexity 30, seed 42),
drawn as a scatter.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import on_device


class TSNEVisualizer:
    """Embed pooled encoder features of many samples in 2D."""

    def __init__(self, model: nn.Module, feature_level: int = -1, perplexity: float = 30.0,
                 n_components: int = 2, seed: int = 42):
        self.model = model
        self.feature_level = feature_level
        self.perplexity = perplexity
        self.n_components = n_components
        self.seed = seed

    @torch.no_grad()
    def _pooled_features(self, x: torch.Tensor) -> torch.Tensor:
        _, feats = self.model(x, capture=True)
        if isinstance(feats, dict):
            feats = feats.get("fused_features", [])
        return feats[self.feature_level].float().mean(dim=(1, 2, 3))  # [B, C]

    def collect(self, samples) -> Dict[str, np.ndarray]:
        """samples: iterable of dicts with ``image`` ``[H, W, D, C]`` (numpy
        or a tensor) and optionally ``label``."""
        vecs, labels = [], []
        for s in samples:
            vecs.append(self._pooled_features(on_device(s["image"], self.model)[None])[0]
                        .cpu().numpy())
            if s.get("label") is not None:
                lbl = np.asarray(s["label"])
                fg = lbl[lbl > 0]
                labels.append(int(np.bincount(fg.ravel()).argmax()) if fg.size else 0)
            else:
                labels.append(0)
        return {"features": np.stack(vecs), "labels": np.asarray(labels)}

    def visualize(self, samples, output_path) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE

        data = self.collect(samples)
        n = len(data["features"])
        perplexity = min(self.perplexity, max(1.0, (n - 1) / 3))
        tsne = TSNE(n_components=self.n_components, perplexity=perplexity,
                    random_state=self.seed, init="pca" if n > self.n_components else "random")
        emb = tsne.fit_transform(data["features"])

        fig, ax = plt.subplots(figsize=(8, 8))
        scatter = ax.scatter(emb[:, 0], emb[:, 1], c=data["labels"], cmap="tab10", s=40)
        ax.set_title("t-SNE of pooled encoder features")
        fig.colorbar(scatter, ax=ax, label="dominant label")
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(output_path, dpi=100)
        plt.close(fig)
        return str(output_path)
