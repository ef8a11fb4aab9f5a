"""Host-side label post-processing for predictions (a copy of the JAX
package's ``ops/postprocess.py``).

Largest-connected-component filtering is the standard clinical cleanup
for organ segmentation (each organ is one connected structure; stray
islands are false positives). Runs on the fetched uint8 mask (scipy
6-connectivity labeling), so it composes with any inference path: batch
CLI and native-grid eval.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def keep_largest_components(
    mask: np.ndarray,
    classes: Optional[Sequence[int]] = None,
    min_voxels: int = 0,
) -> np.ndarray:
    """Per-class largest-connected-component filter.

    For every foreground class (or just ``classes``), keep only the
    largest 6-connected component; dropped voxels become background (0).
    ``min_voxels`` additionally removes a class entirely when even its
    largest component is smaller than the threshold (scanner-noise
    islands). The input is not modified.
    """
    from scipy import ndimage

    out = mask.copy()
    present = np.unique(mask)
    targets = (
        [c for c in present if c != 0]
        if classes is None
        else [c for c in classes if c in present]
    )
    for c in targets:
        m = mask == c
        labeled, n = ndimage.label(m)
        if n == 0:
            continue
        sizes = np.bincount(labeled.ravel())
        sizes[0] = 0
        keep = int(sizes.argmax())
        if min_voxels and sizes[keep] < min_voxels:
            out[m] = 0
            continue
        if n > 1:
            out[m & (labeled != keep)] = 0
    return out


def postprocess_from_config(mask: np.ndarray, config) -> np.ndarray:
    """Apply ``inference.postprocess`` settings to a predicted label map."""
    pp = config.get("inference.postprocess", {}) or {}
    pp = pp.to_dict() if hasattr(pp, "to_dict") else dict(pp)
    if not pp.get("largest_component", False):
        return mask
    classes = pp.get("classes") or None
    return keep_largest_components(
        mask,
        classes=[int(c) for c in classes] if classes else None,
        min_voxels=int(pp.get("min_voxels", 0) or 0),
    )
