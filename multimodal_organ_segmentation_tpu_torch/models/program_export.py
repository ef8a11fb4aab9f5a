"""Exported programs: serving with no model code and no checkpoint (port of
the JAX package's ``models/stablehlo_export.py``, with ``torch.export``).

``export_program`` traces the ROI forward pass (the unit the sliding-window
engine calls) with ``torch.export`` and the deployment weights baked in.
The artifact is one zip: the ``torch.export.save`` program plus a JSON
metadata sidecar. ``load_program`` returns a plain callable: no model
module, no checkpoint, no model config on the serving host.

The tile-batch dimension is exported symbolically, so one artifact serves
any ``sw_batch``. Window and fusion attention stay the custom ops
``organseg_torch::window_mha`` and ``organseg_torch::flash_attention``
(``ops/window_attention.py``, ``ops/flash_attention.py``): on the card the
program launches kernels A and B. So loading a program needs the port's op
library, which ``load_program`` imports; this is the one piece of model
code an artifact needs. The program holds the device it was exported on;
``load_program(path, device=...)`` moves it to another.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_ARTIFACT_MEMBER = "model.pt2"
_METADATA_MEMBER = "metadata.json"
_FORMAT_VERSION = 1
MAX_TILE_BATCH = 4096  # the symbolic tile batch's upper bound


def export_program(
    model: torch.nn.Module,
    out_path,
    *,
    roi: Tuple[int, int, int],
    in_channels: int,
    metadata: Optional[Dict[str, Any]] = None,
) -> Path:
    """Trace ``model`` (eval mode, deployment weights already loaded:
    EMA-selected, see ``train.trainer.select_infer_params``) to ``out_path``.

    Input signature ``f32[b, *roi, in_channels]`` (channels-last, as the
    runner's patches) with ``b`` symbolic; the program runs on the device
    of the model's parameters."""
    device = next(model.parameters()).device
    example = torch.zeros((2, *roi, in_channels), dtype=torch.float32, device=device)
    batch = torch.export.Dim("b", min=1, max=MAX_TILE_BATCH)
    model.eval()
    with torch.no_grad():
        program = torch.export.export(model, (example,), dynamic_shapes=({0: batch},))
    blob = io.BytesIO()
    torch.export.save(program, blob)

    meta = {
        "format_version": _FORMAT_VERSION,
        "input": {
            "shape": ["b", *map(int, roi), int(in_channels)],
            "dtype": "float32",
            "layout": "NDHWC (channels-last; b = symbolic tile batch)",
        },
        "platforms": [device.type],
        "torch_version": torch.__version__,
        **(metadata or {}),
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    # ZIP_STORED for the program: its tensors do not compress, and a flat
    # member keeps the load IO-bound
    with zipfile.ZipFile(out_path, "w") as zf:
        zf.writestr(_ARTIFACT_MEMBER, blob.getvalue(), compress_type=zipfile.ZIP_STORED)
        zf.writestr(_METADATA_MEMBER, json.dumps(meta, indent=2),
                    compress_type=zipfile.ZIP_DEFLATED)
    return out_path


def load_program(path, device=None) -> Tuple[Callable, Dict[str, Any]]:
    """Load an exported artifact; returns ``(call, metadata)``.

    ``call(x)`` runs the baked-weights forward. ``device`` moves the program
    to another device than the one it was exported on. Raises
    ``ValueError`` on a malformed or future-versioned artifact instead of
    failing deep inside deserialization."""
    # the program's attention nodes are the port's custom ops
    import multimodal_organ_segmentation_tpu_torch.ops.flash_attention  # noqa: F401
    import multimodal_organ_segmentation_tpu_torch.ops.window_attention  # noqa: F401

    path = Path(path)
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            if _ARTIFACT_MEMBER not in names or _METADATA_MEMBER not in names:
                raise ValueError(
                    f"{path} is not an exported program artifact (members: {sorted(names)})")
            meta = json.loads(zf.read(_METADATA_MEMBER))
            blob = zf.read(_ARTIFACT_MEMBER)
    except zipfile.BadZipFile as e:
        raise ValueError(f"{path} is not an exported program artifact: {e}") from e
    version = int(meta.get("format_version", 0))
    if version > _FORMAT_VERSION:
        raise ValueError(
            f"{path} was written by a newer exporter "
            f"(format_version {version} > supported {_FORMAT_VERSION})")
    program = torch.export.load(io.BytesIO(blob))
    if device is not None and torch.device(device).type not in meta.get("platforms", []):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program.module(), meta
