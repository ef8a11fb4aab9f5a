"""Serving autotuner (``--mode tune``; port of the JAX package's
``serving/tuner.py``).

Two knobs set the serving throughput of the sliding-window engine, and
their best values depend on the card and the model: the tile chunk size
(``inference.batch_size``, how many ROI tiles one forward takes) and the
window overlap (``inference.sliding_window.overlap``, stride against
blending quality). The chunk has to divide the tile count well and fit the
card's memory, so guessing is wrong at both ends. The tuner measures the
candidates on the target device through the serving path itself
(``SlidingWindowRunner``, the class behind ``--mode serve`` and batch
predict) and writes the winner as a config fragment.

Timing: the volume is made on the device; each run ends in one scalar
fetched to the host (the sum of the label map), which waits for the card.
``compile_s`` is the first, warm-up run of a candidate (eager PyTorch
compiles nothing; the first run pays the kernel build and the allocator).
A failing candidate (out of memory at a large chunk) is recorded and the
sweep goes on. Under ``torchrun`` the ranks time the multi-rank service's
pass together and agree on every candidate (``tune_serving``); rank 0
writes the profile.

One difference from the JAX tuner: the candidates at overlap ≥ 0.25 (the
Dice-parity tier) are the pool for "best" unless ``tune.allow_turbo`` is
set; the sub-tier (turbo) candidates stand in only when the sweep tried no
parity-tier overlap at all. The JAX tuner falls back to them also when every
parity-tier candidate was tried and failed.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

PARITY_OVERLAP = 0.25  # overlaps at or above it keep Dice within the parity tier


def _in_tier(overlap: float) -> bool:
    return overlap >= PARITY_OVERLAP - 1e-9


def select_best(results: List[Dict[str, Any]], allow_turbo: bool = False
                ) -> Optional[Dict[str, Any]]:
    """The fastest eligible candidate, or None: with ``allow_turbo`` every
    measured candidate; otherwise the measured parity-tier candidates, or
    the measured turbo ones only when no parity-tier overlap was tried."""
    ok = [r for r in results if "vol_per_min" in r]
    pool = ok
    if not allow_turbo and any(_in_tier(r["overlap"]) for r in results):
        pool = [r for r in ok if _in_tier(r["overlap"])]
    return max(pool, key=lambda r: r["vol_per_min"]) if pool else None


def tune_serving(
    config,
    logger=None,
    checkpoint: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Sweep (overlap, sw_batch) serving candidates; return measurements.

    Config surface (all optional, under ``tune:``)::

        tune:
          sw_batches: [4, 8, 12, 16]   # tile-chunk candidates
          overlaps: [0.5, 0.25, 0.125] # window-overlap candidates (default:
                                       # the config's overlap + 0.25 / 0.125)
          volume_shape: [192, 192, 256]  # representative case shape
          repeats: 3                   # timed runs per candidate
          allow_turbo: false           # let an overlap < 0.25 be "best"

    Returns ``{"results": [...], "best": {...} | None}`` where each result
    carries ``vol_per_min`` or ``error``. Weights come from ``checkpoint``
    when given (the timing does not depend on their values, so a random
    init measures the same work). Runs on the card unless ``device`` (or the
    config's ``hardware.device``) names the CPU.

    In a job of several ranks (``torchrun``) every rank calls it: each
    candidate runs the pass the multi-rank service runs (the trainer's
    inference mesh: tile chunks over the data axis, one ``all_reduce`` of
    the blend), its times are the slowest rank's, and every rank returns
    the same table and pick. The ranks settle each candidate's outcome by
    votes every rank reaches whether or not its own pass raised
    (``parallel.mesh.agreement``): a vote in front of each collective of the
    pass and one at its end, so a candidate that fails on one rank (out of
    memory at a large chunk) is recorded as failed on every rank, with the
    failing rank's error, and the sweep goes on. The votes run on the host
    over a gloo group and wait for no work on the card; the times include
    them (under tensor parallelism a vote a split layer).
    """
    import torch
    import torch.distributed as dist

    from multimodal_organ_segmentation_tpu_torch.cli import resolve_device
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        SlidingWindowRunner,
        ensemble_run_sw,
        predict_labels,
    )
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import (
        PeerFailed,
        agreement,
        control_group,
    )
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    t_cfg = config.get("tune", {}) or {}
    if hasattr(t_cfg, "to_dict"):
        t_cfg = t_cfg.to_dict()
    sw_batches = [int(s) for s in t_cfg.get("sw_batches", [4, 8, 12, 16])]
    default_ov = float(config.get("inference.sliding_window.overlap", 0.5))
    # the default sweep proposes the fast profiles beside the config's own
    # overlap (deduplicated, the config's first)
    fast_default = [default_ov] + [o for o in (0.25, 0.125) if o != default_ov]
    allow_turbo = bool(t_cfg.get("allow_turbo", False))
    overlaps = [float(o) for o in t_cfg.get("overlaps", fast_default)]
    vol_shape = tuple(int(s) for s in t_cfg.get("volume_shape", [192, 192, 256]))
    repeats = max(1, int(t_cfg.get("repeats", 3)))

    roi = tuple(config.get("inference.sliding_window.roi_size", [96, 96, 96]))
    sw_mode = str(config.get("inference.sliding_window.mode", "gaussian"))
    n_mod = len(config.get("data.modalities", ["CT", "PET"]))
    device = resolve_device(device if device is not None
                            else config.get("hardware.device", None))

    trainer = Trainer(config, logger=logger, device=device)
    trainer.init_state()
    if checkpoint:
        trainer.load_params(checkpoint)
    elif logger:
        logger.info("tune: no --checkpoint; timing a random init "
                    "(throughput is independent of the weight values)")
    trainer.freeze_for_inference()  # moments dropped before tile chunks
    members = trainer._inference_members()
    tta = bool(config.get("inference.tta", False))

    volume = torch.zeros((*vol_shape, n_mod), dtype=torch.float32, device=device)
    control = control_group() if dist.is_available() and dist.is_initialized() else None
    results: List[Dict[str, Any]] = []
    for ov in overlaps:
        for sw in sw_batches:
            rec: Dict[str, Any] = {"overlap": ov, "sw_batch": sw, "volume_shape": list(vol_shape)}
            runner = SlidingWindowRunner(trainer._predict_fn, roi_size=roi,
                                         num_classes=trainer.num_classes, overlap=ov,
                                         sw_batch_size=sw, mode=sw_mode,
                                         mesh=trainer._inference_mesh())
            # the timed work is the deployed one: the TTA flips and the
            # ensemble softmax average that predict_labels serves
            run_sw = ensemble_run_sw(runner, members)

            def run_once():
                labels = predict_labels(run_sw, volume, tta=tta)
                return float(labels.sum())

            with agreement(control) as agree:
                try:
                    t0 = time.perf_counter()
                    run_once()  # warm-up: kernel build, allocator
                    compile_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    for _ in range(repeats):
                        run_once()
                    dt = (time.perf_counter() - t0) / repeats
                    if agree is not None:  # every rank's pass ended: the slowest rank's times
                        failed, (compile_s, dt) = agree.finish(False, (compile_s, dt))
                        if failed:
                            raise PeerFailed("the candidate failed on another rank")
                    rec["compile_s"] = round(compile_s, 1)
                    rec["seconds_per_volume"] = round(dt, 3)
                    rec["vol_per_min"] = round(60.0 / dt, 2)
                except Exception as e:  # out of memory etc.: record, keep sweeping
                    rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                    if agree is not None:
                        # this rank's vote, unless one already told it; then
                        # every rank records the first failing rank's error
                        agree.finish(True)
                        errors = [None] * dist.get_world_size()
                        dist.all_gather_object(
                            errors, None if isinstance(e, PeerFailed) else rec["error"],
                            group=control)
                        r = next(i for i, err in enumerate(errors) if err is not None)
                        rec["error"] = f"{errors[r]} (rank {r})"
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
            results.append(rec)
            if logger:
                logger.info(
                    f"tune: overlap={ov} sw_batch={sw} → "
                    + (f"{rec['vol_per_min']} vol/min (compile {rec['compile_s']}s)"
                       if "vol_per_min" in rec else f"FAILED ({rec['error']})"))

    return {"results": results, "best": select_best(results, allow_turbo)}


def write_profile(report: Dict[str, Any], path) -> None:
    """Write the winning candidate as a pure YAML config fragment.

    The fragment's keys are real config paths — apply with
    ``--set inference.batch_size=... --set
    inference.sliding_window.overlap=...`` or merge into a config file.
    The full sweep record goes to a sibling ``<path>.report.json`` so the
    fragment stays merge-clean. The files are byte for byte those of the
    JAX package's ``write_profile`` for the same report.
    """
    import json

    import yaml

    best = report.get("best")
    if best is None:
        raise RuntimeError(
            "no eligible tuning candidate; nothing to write "
            f"({[r.get('error') for r in report['results']]})")
    doc = {
        "inference": {
            "batch_size": int(best["sw_batch"]),
            "sliding_window": {"overlap": float(best["overlap"])},
        },
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        f.write(
            "# serving profile measured by --mode tune "
            f"({best['vol_per_min']} vol/min at "
            f"overlap={best['overlap']}, sw_batch={best['sw_batch']})\n"
        )
        if not _in_tier(float(best["overlap"])):
            f.write(
                "# NOTE: overlap < 0.25 is the 'turbo' tier — measured "
                "~1% Dice trade vs overlap 0.5 (see configs/"
                "swin_unetr_xattn_flagship_fast.yaml); opt-in only.\n"
            )
        yaml.safe_dump(doc, f, sort_keys=False)
    with open(p.with_suffix(p.suffix + ".report.json"), "w") as f:
        json.dump(report["results"], f, indent=2)
