"""GradCAM / GradCAM++ (port of the JAX package's ``explainability/gradcam.py``).

Semantics as the JAX package's: the segmentation score is the max of the
class logit over the first sample (per tile, the sum over tiles of each
tile's max); the weights are the spatial mean of the gradient of that score
with respect to a layer's activations; cam = ReLU(Σ_c w_c·A_c), linearly
resized to the input grid and minmax-normalised. GradCAM++ weights: α = g² /
(2g² + ΣA·g³), w = Σ α·ReLU(g).

The activations come from the model's ``capture`` taps and the gradients
from its perturbation points (``forward``'s ``perturb`` dict):
``torch.autograd.grad`` of the score with
respect to the live activation is the gradient flax reads from its zero
perturbation. It leaves every parameter's ``.grad`` as it was. One forward
gives both, where the JAX package runs two. On the card kernels A and B run
in that forward, and their custom ops' gradients in the backward.

Layer names are the points' names in the wrapped flax tree
(``backbone/stage4``, ``backbone/feat1``, ``backbone/fused3``), in the order
flax flattens them (``perturb_names``). A target binds to one name: an exact
full-path match first, then an exact leaf match.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import sliding_window_inference

PREFIX = "backbone/"  # the JAX package's MultiModalSegmentationModel wraps its backbone so


def perturb_names(model: nn.Module) -> List[str]:
    """The model's perturbation points as the wrapped flax tree names them,
    in flax's flatten order (dict keys sorted)."""
    return sorted(PREFIX + p for p in getattr(model, "perturb_points", []))


def logits_of(out) -> torch.Tensor:
    """The logits of a model output: under deep supervision in training,
    the first of the outputs."""
    return out[0] if isinstance(out, (tuple, list)) else out


def on_device(x, model: nn.Module) -> torch.Tensor:
    """``x`` (numpy or tensor) as an f32 tensor on the model's device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32,
                           device=next(model.parameters()).device)


def minmax(t: torch.Tensor) -> torch.Tensor:
    return (t - t.min()) / (t.max() - t.min() + 1e-8)


class GradCAM:
    """Class-activation maps from the capture taps and the perturbation
    points' gradients. ``target_layers`` are perturbation names (``"stage4"``,
    ``"backbone/feat1"``, ...)."""

    def __init__(self, model: nn.Module, target_layers: Sequence[str]):
        self.model = model
        self.names = perturb_names(model)
        if not self.names:
            raise ValueError(f"{type(model).__name__} has no perturbation points")
        self.target_layers = list(target_layers)
        missing = [t for t in self.target_layers if self._match(self.names, t) is None]
        if missing:
            raise ValueError(f"target layers {missing} not in perturbation points {self.names}")

    @staticmethod
    def _match(names: Sequence[str], target: str) -> Optional[str]:
        """Bind ``target`` to exactly one name: exact full-path equality
        first, then exact leaf equality ("feat1" never binds "feat10"); two
        leaf matches raise."""
        if target in names:
            return target
        leaf = target.split("/")[-1]
        hits = [nm for nm in names if nm.split("/")[-1] == leaf]
        if len(hits) > 1:
            raise ValueError(f"target layer {target!r} is ambiguous: matches {sorted(hits)}")
        return hits[0] if hits else None

    @staticmethod
    def _activations(hidden) -> Dict[str, torch.Tensor]:
        """The capture taps keyed by the short point names."""
        acts = {}
        if isinstance(hidden, dict):  # DualEncoder
            for i, f in enumerate(hidden.get("fused_features", [])):
                acts[f"fused{i}"] = f
        else:
            for i, f in enumerate(hidden):
                acts[f"feat{i}"] = f
                acts[f"stage{i}"] = f
        return acts

    def _weights_from(self, grad: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return grad.float().mean(dim=(1, 2, 3))  # GAP over space → [B, C]

    def _cams(self, x: torch.Tensor, class_idx: int, per_tile: bool,
              strict: bool) -> Dict[str, torch.Tensor]:
        """Unnormalised CAMs ``[B, H, W, D]`` on ``x``'s grid for each target
        layer. ``per_tile``: the score is the sum over samples of each one's
        max (tiles are independent through the network, so each tile's CAM
        is its own); else the max over the first sample. ``strict`` raises
        on a target without activation (the tile path), else skips it."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            points: Dict[str, torch.Tensor] = {}
            out, hidden = self.model(xg, capture=True, perturb=points)
            logits = logits_of(out)[..., class_idx]
            score = logits.amax(dim=(1, 2, 3)).sum() if per_tile else logits[0].max()
            acts = self._activations(hidden)
            bound = []
            for target in self.target_layers:
                leaf = self._match(self.names, target)[len(PREFIX):]
                act = acts.get(leaf, acts.get(target))
                if act is None:
                    if strict:
                        raise ValueError(f"target layer {target!r} not found among activations "
                                         f"{sorted(acts)} / points {sorted(points)}")
                    continue
                if act.shape != points[leaf].shape:
                    raise ValueError(
                        f"target layer {target!r}: the tap {tuple(act.shape)} and the "
                        f"perturbation point {tuple(points[leaf].shape)} differ in shape")
                bound.append((target, act, points[leaf]))
            grads = torch.autograd.grad(score, [p for _, _, p in bound]) if bound else []
        cams = {}
        for (target, act, _), grad in zip(bound, grads):
            act = act.detach().float()
            w = self._weights_from(grad, act)  # [B, C]
            cam = torch.einsum("bhwdc,bc->bhwd", act, w).clamp_min(0.0)
            cams[target] = resize_linear(cam, tuple(x.shape[1:4]), (1, 2, 3))
        return cams

    def generate(self, x, class_idx: int = 1) -> Dict[str, np.ndarray]:
        """Per-target-layer CAM volumes ``[H, W, D]`` of the first sample of
        ``x`` ``[B, H, W, D, C]``, minmax-normalised over the batch."""
        cams = self._cams(on_device(x, self.model), class_idx, per_tile=False, strict=False)
        return {t: minmax(cam)[0].cpu().numpy() for t, cam in cams.items()}

    def _tile_cams(self, patches: torch.Tensor, class_idx: int) -> torch.Tensor:
        """``[n, *roi, C]`` patches → unnormalised CAMs ``[n, *roi, L]``:
        the tiles share one minmax after the blend, as logits share one
        argmax."""
        cams = self._cams(patches, class_idx, per_tile=True, strict=True)
        return torch.stack([cams[t] for t in self.target_layers], dim=-1)

    def generate_native(
        self,
        volume,
        class_idx: int = 1,
        *,
        roi_size: Tuple[int, int, int],
        overlap: float = 0.5,
        sw_batch_size: int = 4,
        mode: str = "gaussian",
    ) -> Dict[str, np.ndarray]:
        """CAMs on the native grid of ``volume`` ``[H, W, D, C]``: the tile
        grid and Gaussian blend of logits inference, each tile's
        unnormalised CAM, one global minmax after the blend. A volume within
        the ROI is one tile and equals :meth:`generate` on it."""
        blended = sliding_window_inference(
            on_device(volume, self.model),
            lambda patches: self._tile_cams(patches, class_idx),
            roi_size=tuple(roi_size), num_classes=len(self.target_layers), overlap=overlap,
            sw_batch_size=sw_batch_size, mode=mode,
        )  # [H, W, D, L]
        return {t: minmax(blended[..., i]).cpu().numpy()
                for i, t in enumerate(self.target_layers)}


class GradCAMPlusPlus(GradCAM):
    """GradCAM++ weighting."""

    def _weights_from(self, grad: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        g = grad.float()
        g2 = g**2
        g3 = g2 * g
        sum_a_g3 = (act * g3).sum(dim=(1, 2, 3), keepdim=True)
        alpha = g2 / (2.0 * g2 + sum_a_g3 + 1e-8)
        return (alpha * g.clamp_min(0.0)).sum(dim=(1, 2, 3))


def visualize_gradcam(
    image: np.ndarray,
    cam: np.ndarray,
    output_path=None,
    axis: int = 2,
    slice_idx: Optional[int] = None,
    alpha: float = 0.4,
):
    """Overlay a CAM slice on the image: image, CAM, overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image = np.asarray(image)
    if image.ndim == 4:  # [H, W, D, C] → first channel
        image = image[..., 0]
    if slice_idx is None:
        slice_idx = image.shape[axis] // 2
    img_slice = np.take(image, slice_idx, axis=axis)
    cam_slice = np.take(cam, slice_idx, axis=axis)

    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    axes[0].imshow(img_slice.T, cmap="gray", origin="lower")
    axes[0].set_title("image")
    axes[1].imshow(cam_slice.T, cmap="jet", origin="lower")
    axes[1].set_title("GradCAM")
    axes[2].imshow(img_slice.T, cmap="gray", origin="lower")
    axes[2].imshow(cam_slice.T, cmap="jet", alpha=alpha, origin="lower")
    axes[2].set_title("overlay")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if output_path is not None:
        fig.savefig(output_path, dpi=100)
        plt.close(fig)
        return str(output_path)
    return fig
