"""Convert a checkpoint of the JAX package's trainer into one the PyTorch
port's trainer resumes.

    python scripts/jax_checkpoint_to_torch.py --config CONFIG --checkpoint JAX_DIR --output DIR

JAX_DIR is a checkpoint directory the JAX package's ``train/checkpoint.py``
wrote (the Orbax tree and ``meta.json``: params, batch statistics, the
optax state, EMA weights, the step). It is restored with the JAX package's
own ``load_checkpoint`` (numpy arrays) and mapped by the port's
``train/checkpoint.py::from_jax_checkpoint`` for CONFIG, the run's config
(the model and the optimiser to map onto). DIR is written by the port's
``save_checkpoint`` (``tree.pt`` and ``meta.json``); resume it with
``--resume DIR`` or ``Trainer(..., resume_from=DIR)``.

It runs where JAX, Orbax and PyTorch are installed, on the CPU; the port
itself never imports JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def convert(config_path, checkpoint, output) -> dict:
    """Read the JAX checkpoint ``checkpoint``, write the port's at
    ``output``; returns the port's tree."""
    import jax
    import numpy as np

    from multimodal_organ_segmentation_tpu.train.checkpoint import load_checkpoint as jax_load
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import (
        from_jax_checkpoint,
        save_checkpoint,
    )
    from multimodal_organ_segmentation_tpu_torch.utils.config import load_config

    restored = jax_load(checkpoint)
    tree = jax.tree_util.tree_map(np.asarray, restored["tree"])
    done = from_jax_checkpoint(load_config(config_path), tree, restored["meta"])
    meta = dict(done["meta"])
    save_checkpoint(done["tree"], output, epoch=int(meta.pop("epoch", 0)),
                    best_metric=float(meta.pop("best_metric", 0.0)),
                    history=meta.pop("history", {}), **meta)
    return done["tree"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="the run's YAML config")
    parser.add_argument("--checkpoint", required=True, help="the JAX checkpoint directory")
    parser.add_argument("--output", required=True, help="the port's checkpoint directory")
    args = parser.parse_args(argv)
    tree = convert(args.config, args.checkpoint, args.output)
    print(f"step {tree['step']}: {len(tree['params'])} tensors, "
          f"{len(tree['opt_state']['state'])} optimiser slots, EMA "
          f"{'yes' if tree['ema_params'] is not None else 'no'} -> {args.output}")


if __name__ == "__main__":
    main()
