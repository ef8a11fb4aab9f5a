"""Evaluation metrics (port of the JAX package's ``train/metrics.py``).

- ``DiceMetric``      — streaming per-class ∩/∪ accumulators, compute → mean
                        foreground dice + per-class list, smooth 1e-5. The
                        per-batch update is one reduction on the tensors'
                        device; the accumulator is a small f64 host vector.
- ``ConfusionMatrix`` — one ``bincount`` over ``t * C + p`` indices.
- ``HausdorffDistance``, ``SurfaceDice`` (NSD), ``AverageSurfaceDistance``
  (ASSD) — host numpy on the fetched masks, distances from the native EDT
  (``ops/edt.py``, which raises rather than fall back).
- ``LesionDetectionMetric`` — per-component TP/FP/FN (scipy labelling).
- ``CalibrationError`` — voxel ECE; its per-bin update is a reduction on the
  posterior's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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


def _distance_transform(mask: np.ndarray, sampling) -> np.ndarray:
    """EDT of the background of ``mask`` (distance to nearest True voxel),
    through the native kernel (``ops/edt.py``; raises if it cannot be
    built)."""
    from multimodal_organ_segmentation_tpu_torch.ops.edt import distance_transform_edt

    return distance_transform_edt(~mask, sampling=sampling)


class HausdorffDistance:
    """Percentile Hausdorff distance on foreground-union surfaces, with the
    xor-roll border extraction."""

    def __init__(self, percentile: float = 95):
        self.percentile = percentile
        self.distances: list = []

    def reset(self) -> None:
        self.distances = []

    def update(
        self,
        pred,
        target,
        spacing: Optional[Tuple[float, float, float]] = None,
    ) -> None:
        pred = np.asarray(pred)
        target = np.asarray(target)
        spacing = spacing or (1.0, 1.0, 1.0)

        for b in range(pred.shape[0]):
            pred_b = pred[b] > 0
            target_b = target[b] > 0
            if pred_b.sum() == 0 or target_b.sum() == 0:
                continue

            dist_pred = _distance_transform(pred_b, spacing)
            dist_target = _distance_transform(target_b, spacing)

            border_pred = pred_b ^ np.roll(pred_b, 1, axis=0)
            border_target = target_b ^ np.roll(target_b, 1, axis=0)

            d1 = dist_target[border_pred]
            d2 = dist_pred[border_target]
            all_d = np.concatenate([d1, d2])
            if len(all_d) > 0:
                self.distances.append(np.percentile(all_d, self.percentile))

    def compute(self) -> Dict[str, float]:
        if not self.distances:
            return {"hausdorff_distance": float("inf")}
        return {
            "hausdorff_distance": float(np.mean(self.distances)),
            "hausdorff_distance_std": float(np.std(self.distances)),
        }


def _boundary_voxels(mask: np.ndarray) -> np.ndarray:
    """6-connected boundary of a binary mask: mask voxels with at least one
    face-neighbor outside the mask (volume edges count as outside)."""
    if not mask.any():
        return np.zeros_like(mask)
    padded = np.pad(mask, 1, constant_values=False)
    inner = tuple(slice(1, -1) for _ in range(mask.ndim))
    core = mask.copy()
    for ax in range(mask.ndim):
        for off in (-1, 1):
            s = list(inner)
            s[ax] = slice(1 + off, padded.shape[ax] - 1 + off)
            core &= padded[tuple(s)]
    return mask & ~core


def _surface_distances(pred_m, gt_m, spacing, cache=None, key=None):
    """Boundary sizes + directed surface-distance samples for one class.

    Returns ``(n_p, n_g, d_p, d_g)`` where ``d_p`` holds the distance from
    each pred-boundary voxel to the GT surface and ``d_g`` vice versa;
    the distance arrays are ``None`` when either boundary is empty. With
    ``cache`` (a per-case dict) the EDT pair is computed once and shared
    between the surface metrics (NSD + ASSD) scoring the same prediction.
    """
    if cache is not None and key in cache:
        return cache[key]
    bp = _boundary_voxels(pred_m)
    bg = _boundary_voxels(gt_m)
    n_p, n_g = int(bp.sum()), int(bg.sum())
    if n_p == 0 or n_g == 0:
        out = (n_p, n_g, None, None)
    else:
        out = (
            n_p,
            n_g,
            _distance_transform(bg, spacing)[bp],
            _distance_transform(bp, spacing)[bg],
        )
    if cache is not None:
        cache[key] = out
    return out


class SurfaceDice:
    """Normalized Surface Dice (NSD) at a tolerance in mm.

    The boundary-agreement metric of the DeepMind surface-distance
    protocol: the fraction of each segmentation's surface lying within
    ``tolerance_mm`` of the other's surface,
    ``(|S_p: d(·, S_g) ≤ τ| + |S_g: d(·, S_p) ≤ τ|) / (|S_p| + |S_g|)``.
    Complements volume-overlap Dice with boundary fidelity. Distances use
    the same native EDT as ``HausdorffDistance``, with anisotropic voxel
    spacing."""

    def __init__(
        self,
        num_classes: int,
        tolerance_mm: float = 2.0,
        include_background: bool = False,
    ):
        self.num_classes = num_classes
        self.tolerance_mm = float(tolerance_mm)
        self.include_background = include_background
        self.reset()

    def reset(self) -> None:
        self._scores: list = [[] for _ in range(self.num_classes)]

    @staticmethod
    def _nsd_binary(pred_m, gt_m, spacing, tol: float, cache=None, key=None) -> float:
        n_p, n_g, d_p, d_g = _surface_distances(pred_m, gt_m, spacing, cache, key)
        if n_p == 0 and n_g == 0:
            return 1.0  # both empty: perfect agreement
        if d_p is None:
            return 0.0
        agree = int((d_p <= tol).sum()) + int((d_g <= tol).sum())
        return agree / (n_p + n_g)

    def update(
        self,
        pred,
        target,
        spacing: Optional[Tuple[float, float, float]] = None,
        distance_cache: Optional[dict] = None,
    ) -> None:
        pred = np.asarray(pred)
        target = np.asarray(target)
        spacing = spacing or (1.0, 1.0, 1.0)
        start = 0 if self.include_background else 1
        for b in range(pred.shape[0]):
            for c in range(start, self.num_classes):
                gt_m = target[b] == c
                pred_m = pred[b] == c
                if not gt_m.any() and not pred_m.any():
                    continue  # class absent from this case: no evidence
                self._scores[c].append(
                    self._nsd_binary(
                        pred_m, gt_m, spacing, self.tolerance_mm,
                        distance_cache, (b, c),
                    )
                )

    def compute(self) -> Dict[str, Any]:
        per_class = [
            float(np.mean(s)) if s else float("nan") for s in self._scores
        ]
        start = 0 if self.include_background else 1
        seen = [s for s in per_class[start:] if not np.isnan(s)]
        return {
            "surface_dice": float(np.mean(seen)) if seen else float("nan"),
            "surface_dice_per_class": per_class,
            "surface_dice_tolerance_mm": self.tolerance_mm,
        }


class AverageSurfaceDistance:
    """Average symmetric surface distance (ASSD) in mm, per class.

    ``(Σ d(S_p → S_g) + Σ d(S_g → S_p)) / (|S_p| + |S_g|)`` — the mean
    boundary error that HD95 (worst-case tail) and NSD (within-tolerance
    fraction) bracket; the third member of the standard medical-seg surface
    suite (MSD / nnU-Net evaluation protocol). Distances ride the same
    native EDT as the other surface metrics and share their per-case EDT
    pair through ``distance_cache``.

    Empty-mask rule: a class absent from BOTH pred and GT contributes no
    evidence; a one-sided miss has no finite surface distance and is
    likewise skipped (matching ``HausdorffDistance``'s empty-case rule) —
    Dice and NSD already penalize total misses, so ASSD stays a pure
    boundary-quality readout over cases where both surfaces exist.
    """

    def __init__(self, num_classes: int, include_background: bool = False):
        self.num_classes = num_classes
        self.include_background = include_background
        self.reset()

    def reset(self) -> None:
        self._scores: list = [[] for _ in range(self.num_classes)]

    def update(
        self,
        pred,
        target,
        spacing: Optional[Tuple[float, float, float]] = None,
        distance_cache: Optional[dict] = None,
    ) -> None:
        pred = np.asarray(pred)
        target = np.asarray(target)
        spacing = spacing or (1.0, 1.0, 1.0)
        start = 0 if self.include_background else 1
        for b in range(pred.shape[0]):
            for c in range(start, self.num_classes):
                pred_m = pred[b] == c
                gt_m = target[b] == c
                if not gt_m.any() and not pred_m.any():
                    continue
                n_p, n_g, d_p, d_g = _surface_distances(
                    pred_m, gt_m, spacing, distance_cache, (b, c)
                )
                if d_p is None:
                    continue  # one side empty: no finite surface distance
                self._scores[c].append(
                    (float(d_p.sum()) + float(d_g.sum())) / (n_p + n_g)
                )

    def compute(self) -> Dict[str, Any]:
        per_class = [
            float(np.mean(s)) if s else float("nan") for s in self._scores
        ]
        start = 0 if self.include_background else 1
        seen = [s for s in per_class[start:] if not np.isnan(s)]
        return {
            "assd": float(np.mean(seen)) if seen else float("nan"),
            "assd_per_class": per_class,
        }


class LesionDetectionMetric:
    """Lesion-wise detection counts (per-lesion TP/FP/FN → precision /
    recall / F1), per class.

    Voxel-wise Dice hides whether small lesions were found at all — a
    missed 50-voxel lesion next to a well-segmented 50k-voxel one barely
    moves Dice. This scores each 6-connected component separately
    (autoPET-style criteria): a GT lesion counts DETECTED when pred
    voxels of the same class cover more than ``overlap_threshold`` of it
    (default: any overlap); a pred component touching no GT voxel of the
    class is a false positive.

    ``classes`` restricts scoring to the lesion-like labels (e.g. the
    tumor class) — organ classes are 1-component by anatomy and belong
    to the surface metrics instead.
    """

    def __init__(
        self,
        num_classes: int,
        include_background: bool = False,
        overlap_threshold: float = 0.0,
        classes: Optional[Sequence[int]] = None,
    ):
        self.num_classes = num_classes
        self.include_background = include_background
        self.overlap_threshold = float(overlap_threshold)
        start = 0 if include_background else 1
        self.classes = (
            [int(c) for c in classes]
            if classes
            else list(range(start, num_classes))
        )
        self.reset()

    def reset(self) -> None:
        # per-class running counts over the cohort
        self._tp = [0] * self.num_classes
        self._fp = [0] * self.num_classes
        self._fn = [0] * self.num_classes

    def _match_case(self, pred_m: np.ndarray, gt_m: np.ndarray):
        """Component-match one (case, class) pair → (tp, fp, fn)."""
        from scipy import ndimage

        gt_lab, n_gt = ndimage.label(gt_m)
        pred_lab, n_pred = ndimage.label(pred_m)
        tp = 0
        if n_gt:
            # overlap fraction per GT lesion: |pred ∩ lesion| / |lesion|
            inter = np.bincount(gt_lab[pred_m], minlength=n_gt + 1)[1:]
            sizes = np.bincount(gt_lab.ravel(), minlength=n_gt + 1)[1:]
            tp = int((inter / sizes > self.overlap_threshold).sum())
        fn = n_gt - tp
        fp = 0
        if n_pred:
            hit = np.unique(pred_lab[gt_m])
            fp = n_pred - int((hit > 0).sum())
        return tp, fp, fn

    def update(self, pred, target) -> list:
        """Accumulate one batch; returns per-sample count dicts (for
        per-case tables)."""
        pred = np.asarray(pred)
        target = np.asarray(target)
        rows = []
        for b in range(pred.shape[0]):
            row = {"lesion_tp": 0, "lesion_fp": 0, "lesion_fn": 0}
            for c in self.classes:
                tp, fp, fn = self._match_case(pred[b] == c, target[b] == c)
                self._tp[c] += tp
                self._fp[c] += fp
                self._fn[c] += fn
                row["lesion_tp"] += tp
                row["lesion_fp"] += fp
                row["lesion_fn"] += fn
            rows.append(row)
        return rows

    def compute(self) -> Dict[str, Any]:
        def prf(tp, fp, fn):
            p = tp / (tp + fp) if tp + fp else float("nan")
            r = tp / (tp + fn) if tp + fn else float("nan")
            f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else float("nan")
            return p, r, f1

        per_class = [
            prf(self._tp[c], self._fp[c], self._fn[c])
            if c in self.classes
            else (float("nan"),) * 3
            for c in range(self.num_classes)
        ]
        tp = sum(self._tp[c] for c in self.classes)
        fp = sum(self._fp[c] for c in self.classes)
        fn = sum(self._fn[c] for c in self.classes)
        p, r, f1 = prf(tp, fp, fn)
        return {
            "lesion_precision": p,
            "lesion_recall": r,
            "lesion_f1": f1,
            "lesion_tp": tp,
            "lesion_fp": fp,
            "lesion_fn": fn,
            "lesion_f1_per_class": [x[2] for x in per_class],
        }


def _ece_update(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10):
    """Per-bin (count, confidence sum, correct count) of one volume, as f64
    tensors ``[n_bins]`` on the posterior's device.

    ``probs`` is the per-voxel class posterior ``[..., C]``; confidence is
    its max, a voxel is correct when the argmax matches ``labels``. The sums
    run in f64 on the device (exact counts, and no f32 drift on
    ~100M-voxel grids), so only ``3·n_bins`` scalars are fetched a case."""
    conf, pred = probs.max(dim=-1)
    conf = conf.reshape(-1)
    labels = labels.to(probs.device).reshape(-1)
    correct = (pred.reshape(-1) == labels).to(torch.float64)
    # conf ∈ (1/C, 1]; clip 1.0 into the last bin
    idx = (conf * n_bins).to(torch.int64).clamp(0, n_bins - 1)
    zeros = torch.zeros(n_bins, dtype=torch.float64, device=probs.device)
    count = torch.bincount(idx, minlength=n_bins).to(torch.float64)
    return (count, zeros.index_add(0, idx, conf.to(torch.float64)),
            zeros.index_add(0, idx, correct))


class CalibrationError:
    """Voxel-level Expected Calibration Error (ECE) of the deployed model.

    ``ECE = Σ_b (n_b / N) · |acc_b − conf_b|`` over ``n_bins`` equal-width
    confidence bins: how far the softmax confidence is from the empirical
    accuracy it claims (Guo et al. 2017). Accumulation is on the device
    (``_ece_update``).
    """

    def __init__(self, n_bins: int = 10):
        self.n_bins = int(n_bins)
        self.reset()

    def reset(self) -> None:
        self.count = np.zeros(self.n_bins, np.float64)
        self.conf_sum = np.zeros(self.n_bins, np.float64)
        self.correct_sum = np.zeros(self.n_bins, np.float64)

    @staticmethod
    def _ece(count, conf_sum, correct_sum) -> float:
        n = count.sum()
        if n == 0:
            return float("nan")
        nz = count > 0
        gap = np.abs(correct_sum[nz] / count[nz] - conf_sum[nz] / count[nz])
        return float((count[nz] / n * gap).sum())

    def update(self, probs, labels) -> float:
        """Accumulate one case; returns the case's own ECE."""
        c, s, k = (t.cpu().numpy() for t in
                   _ece_update(_as_tensor(probs), _as_tensor(labels), n_bins=self.n_bins))
        self.count += c
        self.conf_sum += s
        self.correct_sum += k
        return self._ece(c, s, k)

    def compute(self) -> Dict[str, Any]:
        return {
            "ece": self._ece(self.count, self.conf_sum, self.correct_sum),
            "ece_bins": self.n_bins,
        }


def get_metrics(config) -> Dict[str, Any]:
    """Metric factory."""
    num_classes = int(config.get("model.out_channels", 8))
    return {
        "dice": DiceMetric(num_classes=num_classes),
        "confusion": ConfusionMatrix(num_classes=num_classes),
    }
