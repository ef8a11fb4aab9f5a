"""``--mode explain``: the enabled explainability tools over the discovered
cases (port of the JAX package's ``explainability/runner.py``).

The model is built on the device (the card unless ``device`` names
another), its weights the checkpoint's deployed
ones (the EMA where the checkpoint carries one and ``training.ema_eval``,
as eval and inference choose them). Per case: GradCAM on the last
perturbation point, attention maps and integrated gradients, each on the
ROI-resized input and, with ``explainability.native_grid``, on the native
grid through the sliding window (``inference.batch_size`` tiles a chunk);
then t-SNE over the cases. Each tool's wall time goes to the log.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.explainability.attention import AttentionVisualizer
from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import (
    GradCAM,
    perturb_names,
    visualize_gradcam,
)
from multimodal_organ_segmentation_tpu_torch.explainability.shap_analysis import SHAPAnalyzer
from multimodal_organ_segmentation_tpu_torch.explainability.tsne import TSNEVisualizer
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir, load_nifti, save_nifti


def load_explain_model(config, checkpoint, device: Optional[Union[str, torch.device]] = None):
    """The serving model of ``config`` on ``device``, carrying the
    checkpoint's deployed weights."""
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import load_checkpoint
    from multimodal_organ_segmentation_tpu_torch.train.trainer import _select_tree_params

    model = build_model(config, device=device)
    tree = load_checkpoint(checkpoint, map_location=next(model.parameters()).device)["tree"]
    model.load_state_dict(tree["params"])
    # the EMA tree holds the parameters only: the buffers stay the params'
    model.load_state_dict(_select_tree_params(tree, config), strict=False)
    return model


def discover_cases(input_path, modalities) -> Dict[str, Dict[str, Path]]:
    """``<input>/<modality>/<case>.nii[.gz]`` → {case: {modality: path}},
    cases with every modality only."""
    cases: Dict[str, Dict[str, Path]] = {}
    for mod in modalities:
        mdir = Path(input_path) / mod.lower()
        if not mdir.exists():
            continue
        for p in sorted(list(mdir.glob("*.nii")) + list(mdir.glob("*.nii.gz"))):
            case = p.name.replace(".nii.gz", "").replace(".nii", "")
            cases.setdefault(case, {})[mod] = p
    return {c: m for c, m in cases.items() if len(m) == len(modalities)}


def run_explainability(config, checkpoint, input_path, output_path, logger=None,
                       device: Optional[Union[str, torch.device]] = None) -> Dict[str, List[str]]:
    model = load_explain_model(config, checkpoint, device)
    dev = next(model.parameters()).device
    output_path = ensure_dir(output_path)
    roi = tuple(config.get("model.backbone.img_size", [96, 96, 96]))
    modalities = list(config.get("data.modalities", ["CT", "PET"]))
    cases = discover_cases(input_path, modalities)
    if logger:
        logger.info(f"Explainability over {len(cases)} cases")

    # native_grid: maps on the native grid through the sliding window
    # (per-tile maps, Gaussian-blended like logits) instead of the reference's
    # resize of the whole volume to the ROI
    native = bool(config.get("explainability.native_grid", False))
    sw = dict(roi_size=roi, overlap=float(config.get("inference.sliding_window.overlap", 0.5)),
              sw_batch_size=int(config.get("inference.batch_size", 4)))

    def timed(what, case, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if logger:
            logger.info(f"{case}: {what} {time.perf_counter() - t0:.3f} s")
        return out

    written: Dict[str, List[str]] = {"gradcam": [], "attention": [], "shap": []}
    samples = []
    for case, mods in cases.items():
        image = np.stack([load_nifti(mods[m]).astype(np.float32) for m in modalities], axis=-1)
        x = resize_linear(torch.from_numpy(image).to(dev), roi, (0, 1, 2))[None]
        samples.append({"image": x[0]})

        if bool(config.get("explainability.gradcam.enabled", False)):
            names = perturb_names(model)
            cam_gen = GradCAM(model, names[-1:])
            if native:
                cam = timed("gradcam native", case,
                            lambda: cam_gen.generate_native(image, class_idx=1, **sw))
            else:
                cam = timed("gradcam", case, lambda: cam_gen.generate(x, class_idx=1))
            cam_image = image if native else x[0].cpu().numpy()
            for layer, vol in cam.items():
                safe = layer.replace("/", "_")
                out = output_path / f"{case}_gradcam_{safe}.png"
                visualize_gradcam(cam_image, vol, out)
                save_nifti(vol, output_path / f"{case}_gradcam_{safe}.nii.gz")
                written["gradcam"].append(str(out))

        if bool(config.get("explainability.attention_maps.enabled", False)):
            viz = AttentionVisualizer(model)
            if native:
                try:
                    sals = timed("attention native", case, lambda: viz.saliency_native(image, **sw))
                except ValueError:
                    sals = []  # the model sows no foldable window attention
                for li, sal in enumerate(sals):
                    p = output_path / f"{case}_attention_native_{li}.nii.gz"
                    save_nifti(sal, p)
                    written["attention"].append(str(p))
            written["attention"].extend(
                timed("attention", case, lambda: viz.visualize(x, output_path / f"{case}_attention")))

        if bool(config.get("explainability.shap.enabled", False)):
            shap = SHAPAnalyzer(model, n_steps=int(config.get("explainability.shap.n_samples", 50)))
            attr = timed("integrated gradients", case,
                         lambda: shap.integrated_gradients(x, class_idx=1))
            out = output_path / f"{case}_integrated_gradients.png"
            shap.visualize(x, attr, out)
            written["shap"].append(str(out))
            if native:
                # IG on the scanner grid: per-tile IG, Gaussian-blended; one
                # signed NIfTI per modality channel
                attr_n = timed("integrated gradients native", case,
                               lambda: shap.integrated_gradients_native(image, class_idx=1, **sw))
                for ci, mod in enumerate(modalities):
                    p = output_path / f"{case}_ig_native_{mod.lower()}.nii.gz"
                    save_nifti(attr_n[..., ci], p)
                    written["shap"].append(str(p))

    if bool(config.get("explainability.tsne.enabled", False)) and len(samples) >= 3:
        viz = TSNEVisualizer(model, perplexity=float(config.get("explainability.tsne.perplexity", 30)))
        written["tsne"] = [timed("tsne", "all cases",
                                 lambda: viz.visualize(samples, output_path / "tsne.png"))]
    if logger and dev.type == "cuda":
        logger.info(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return written
