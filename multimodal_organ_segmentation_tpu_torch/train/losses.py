"""Segmentation losses as plain functions on tensors (port of the JAX
package's ``train/losses.py``, same numerical contracts):

- ``dice_loss``     — softmax + one-hot + (2∩+s)/(∪+s), smooth=1.0,
                      background included by default, mean over (batch, class).
- ``cross_entropy`` — ``nn.CrossEntropyLoss`` semantics incl. the
                      weighted-mean normalisation by Σw over target voxels.
- ``focal_loss``    — CE → pt=exp(−CE) → (1−pt)^γ·CE, γ=2.
- ``tversky_loss``  — TP/(TP+αFP+βFN), α=β=0.5.
- ``dice_ce_loss``  — 0.5/0.5 weighted combination.

Layout: logits are channels-last ``[B, H, W, D, C]``; labels are integer
``[B, H, W, D]``. Reductions happen in f32 whatever the input dtype (f64
stays f64).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import active_rows, all_reduce_sum


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Cast up to f32 for reductions, keeping f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _class_vector(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=like.device)


def dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smooth: float = 1.0,
    include_background: bool = True,
    apply_softmax: bool = True,
    reduction: str = "mean",
) -> torch.Tensor:
    """Soft Dice loss over ``[B, ..., C]`` logits and integer labels."""
    num_classes = logits.shape[-1]
    probs = _at_least_f32(logits)
    if apply_softmax:
        probs = torch.softmax(probs, dim=-1)
    target = _one_hot(labels, num_classes)

    if not include_background:
        probs = probs[..., 1:]
        target = target[..., 1:]

    b, c = probs.shape[0], probs.shape[-1]
    probs_flat = probs.reshape(b, -1, c)
    target_flat = target.reshape(b, -1, c)

    intersection = (probs_flat * target_flat).sum(dim=1)  # [B, C]
    union = probs_flat.sum(dim=1) + target_flat.sum(dim=1)

    dice = (2.0 * intersection + smooth) / (union + smooth)
    return _reduce(1.0 - dice, reduction)


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross entropy with the weighted-mean reduction of
    ``nn.CrossEntropyLoss``.

    On a batch split over ranks (``parallel.mesh.rows``) the weighted mean
    is the global batch's, Σw·nll over Σw of every rank's rows: the rank's
    Σw·nll is divided by the global Σw (summed over the data group) and
    scaled by the number of row blocks, so that the mean of the ranks'
    losses, which the data-parallel step takes, is the one-process loss."""
    logp = torch.log_softmax(_at_least_f32(logits), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if class_weights is not None:
        w = _class_vector(class_weights, logits)[labels.long()]
        nll = nll * w
        if reduction == "mean":
            den = w.sum()
            split = active_rows()
            if split is not None:
                start, count, total, mesh = split
                if int(mesh.shape["data"]) > 1:
                    den = all_reduce_sum(den, mesh) * (count / total)
            return nll.sum() / den.clamp_min(1e-12)
    return _reduce(nll, reduction)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Focal loss; ``alpha`` maps to CE's per-class ``weight``."""
    ce = cross_entropy_loss(logits, labels, class_weights=None, reduction="none")
    if alpha is not None:
        ce = ce * _class_vector(alpha, logits)[labels.long()]
    pt = torch.exp(-ce)
    return _reduce((1.0 - pt) ** gamma * ce, reduction)


def tversky_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    smooth: float = 1.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Tversky loss (generalised Dice with FP/FN control)."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(_at_least_f32(logits), dim=-1)
    target = _one_hot(labels, num_classes)

    b, c = probs.shape[0], probs.shape[-1]
    p = probs.reshape(b, -1, c)
    t = target.reshape(b, -1, c)

    tp = (p * t).sum(dim=1)
    fp = (p * (1.0 - t)).sum(dim=1)
    fn = ((1.0 - p) * t).sum(dim=1)

    tversky = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return _reduce(1.0 - tversky, reduction)


def dice_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    dice_weight: float = 0.5,
    ce_weight: float = 0.5,
    class_weights: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    include_background: bool = True,
) -> torch.Tensor:
    """Weighted Dice + CE combination."""
    d = dice_loss(logits, labels, include_background=include_background)
    ce = cross_entropy_loss(logits, labels, class_weights=class_weights)
    return dice_weight * d + ce_weight * ce


LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def get_loss(config) -> LossFn:
    """Loss factory keyed by ``training.loss.name``; an unknown name falls
    back to ``dice_ce``."""
    loss_cfg = config.get("training.loss", {}) or {}
    name = str(loss_cfg.get("name", "dice_ce")).lower()

    cw = loss_cfg.get("class_weights")
    class_weights = [float(w) for w in cw] if cw is not None else None

    if name == "dice":
        return lambda logits, labels: dice_loss(logits, labels)
    if name in ("ce", "cross_entropy"):
        return lambda logits, labels: cross_entropy_loss(
            logits, labels, class_weights=class_weights
        )
    if name == "focal":
        return lambda logits, labels: focal_loss(logits, labels, alpha=class_weights)
    if name == "tversky":
        a = float(loss_cfg.get("tversky_alpha", 0.5))
        b = float(loss_cfg.get("tversky_beta", 0.5))
        return lambda logits, labels: tversky_loss(logits, labels, alpha=a, beta=b)
    # dice_ce and fallback default
    dw = float(loss_cfg.get("dice_weight", 0.5))
    cew = float(loss_cfg.get("ce_weight", 0.5))
    return lambda logits, labels: dice_ce_loss(
        logits, labels, dice_weight=dw, ce_weight=cew, class_weights=class_weights
    )


def with_deep_supervision(loss_fn: LossFn) -> LossFn:
    """Wrap a ``(logits, labels)`` loss so it also accepts a LIST of
    multi-scale logits ``[main, aux_fine, ..., aux_coarse]`` (all upsampled
    to the label grid): the nnU-Net-weighted sum ``Σ 2^-k · L_k / Σ 2^-k``.
    Single-tensor logits pass through untouched."""

    def wrapped(logits, labels):
        if isinstance(logits, (list, tuple)):
            weights = [0.5**i for i in range(len(logits))]
            total = sum(w * loss_fn(lg, labels) for w, lg in zip(weights, logits))
            return total / sum(weights)
        return loss_fn(logits, labels)

    return wrapped
