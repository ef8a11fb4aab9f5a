"""Evaluation metrics (port of the JAX package's ``train/metrics.py``:
``DiceMetric`` and ``ConfusionMatrix``; the distance-transform metrics come
with the evaluation slice).

- ``DiceMetric``      — streaming per-class ∩/∪ accumulators, compute → mean
                        foreground dice + per-class list, smooth 1e-5. The
                        per-batch update is one reduction on the tensors'
                        device; the accumulator is a small f64 host vector.
- ``ConfusionMatrix`` — one ``bincount`` over ``t * C + p`` indices.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def dice_update(pred: torch.Tensor, target: torch.Tensor,
                num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class intersection and union sums over the whole batch (f32)."""
    pred_oh = F.one_hot(pred.long(), num_classes).to(torch.float32)
    tgt_oh = F.one_hot(target.long(), num_classes).to(torch.float32)
    axes = tuple(range(pred_oh.dim() - 1))
    inter = (pred_oh * tgt_oh).sum(dim=axes)
    union = pred_oh.sum(dim=axes) + tgt_oh.sum(dim=axes)
    return inter, union


class DiceMetric:
    """Streaming Dice over integer prediction/target volumes."""

    def __init__(self, num_classes: int, include_background: bool = False,
                 reduction: str = "mean"):
        self.num_classes = num_classes
        self.include_background = include_background
        self.reduction = reduction
        self.reset()

    def reset(self) -> None:
        self.intersection = np.zeros(self.num_classes, dtype=np.float64)
        self.union = np.zeros(self.num_classes, dtype=np.float64)
        self.count = 0

    def update(self, pred, target) -> None:
        pred = _as_tensor(pred)
        inter, union = dice_update(pred, _as_tensor(target).to(pred.device), self.num_classes)
        self.intersection += inter.double().cpu().numpy()
        self.union += union.double().cpu().numpy()
        self.count += 1

    def compute(self) -> Dict[str, Any]:
        smooth = 1e-5
        dice_per_class = (2.0 * self.intersection + smooth) / (self.union + smooth)
        start = 0 if self.include_background else 1
        return {
            "dice": float(np.mean(dice_per_class[start:])),
            "dice_per_class": dice_per_class.tolist(),
        }


class ConfusionMatrix:
    """Vectorised multi-class confusion matrix (rows=target, cols=pred)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self.matrix = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def update(self, pred, target) -> None:
        pred = _as_tensor(pred)
        target = _as_tensor(target).to(pred.device)
        c = self.num_classes
        idx = target.reshape(-1).long() * c + pred.reshape(-1).long()
        counts = torch.bincount(idx, minlength=c * c)[: c * c]
        self.matrix += counts.reshape(c, c).cpu().numpy().astype(np.int64)

    def compute(self) -> Dict[str, Any]:
        tp = np.diag(self.matrix).astype(np.float64)
        fp = self.matrix.sum(axis=0) - tp
        fn = self.matrix.sum(axis=1) - tp

        precision = tp / (tp + fp + 1e-8)
        recall = tp / (tp + fn + 1e-8)
        f1 = 2 * precision * recall / (precision + recall + 1e-8)
        accuracy = tp.sum() / (self.matrix.sum() + 1e-8)

        return {
            "accuracy": float(accuracy),
            "precision": float(precision.mean()),
            "recall": float(recall.mean()),
            "f1": float(f1.mean()),
            "precision_per_class": precision.tolist(),
            "recall_per_class": recall.tolist(),
            "f1_per_class": f1.tolist(),
            "confusion_matrix": self.matrix.tolist(),
        }
