"""CLI of the PyTorch port (port of the JAX package's ``cli.py``).

    python -m multimodal_organ_segmentation_tpu_torch --mode train --config configs/x.yaml
    python -m multimodal_organ_segmentation_tpu_torch --mode eval --checkpoint outputs/x/best
    python -m multimodal_organ_segmentation_tpu_torch --mode inference \
        --checkpoint outputs/x/best --input data/test --output predictions
    python -m multimodal_organ_segmentation_tpu_torch --mode serve --checkpoint outputs/x/best
    python -m multimodal_organ_segmentation_tpu_torch --mode tune --output tuned.yaml
    python -m multimodal_organ_segmentation_tpu_torch --mode export --format pt2 \
        --checkpoint outputs/x/best --output model.pt2
    python -m multimodal_organ_segmentation_tpu_torch --mode explain \
        --checkpoint outputs/x/best --input data/test --output explain --gradcam
    python -m multimodal_organ_segmentation_tpu_torch --mode analysis \
        --input case_dir --output analysis --suv-analysis --tmtv-analysis --generate-report
    python -m multimodal_organ_segmentation_tpu_torch --mode preprocess \
        --input data/raw --output data/processed

The same mode vocabulary, flags and config overrides (``--set KEY=VALUE``)
as the JAX CLI. ``train``, ``eval`` (resized-grid, or native-grid with
``evaluation.sliding_window: true``), ``inference``, ``serve`` (the HTTP
service), ``tune`` (the serving tuner), ``export`` (``--format torch``: a
reference ``.pth``; ``--format pt2``: an exported program), ``explain``
(GradCAM, attention maps, integrated gradients, t-SNE), ``analysis``
(SUV, TMTV/TLG, histograms, reports) and ``preprocess`` (DICOM → NIfTI,
spacing resample, SUV, registration) run here. Every mode runs on the CUDA
device unless ``--device cpu`` asks for the CPU; without a card
it raises, it never falls back to the CPU. Checkpoints are the port's own
(``tree.pt`` directories).

Several processes, one per device (``parallel.multihost``, default auto)::

    torchrun --nproc_per_node N -m multimodal_organ_segmentation_tpu_torch --mode train ...

The process group starts before anything else (NCCL on the card, where each
rank takes ``cuda:LOCAL_RANK``; gloo with ``--device cpu``); the trainer then
splits batches, tile chunks or cases over the data axis of its mesh and,
with ``parallel.mesh.model`` > 1, a SwinUNETR's or UNet3D's layers over the
model axis (tensor parallelism), and rank 0 writes the metrics, checkpoints
and logs (the other ranks log to ``<mode>.rank<k>.log``). ``--mode serve``
under ``torchrun``: rank 0 serves HTTP and broadcasts each request to the
other ranks, which run the pass with it (``serving/server.py``); ``--mode
tune`` under ``torchrun`` times that multi-rank pass on every rank, the
ranks agree on each candidate (``serving/tuner.py``), and rank 0 writes the
profile.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from pathlib import Path

import torch

from multimodal_organ_segmentation_tpu_torch.utils.config import (
    load_config,
    merge_config_with_args,
)
from multimodal_organ_segmentation_tpu_torch.utils.logger import setup_logger
from multimodal_organ_segmentation_tpu_torch.utils.prng import set_seed

_DEFAULT_CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "default.yaml")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Multi-modal medical image segmentation, PyTorch/CUDA port",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--mode", required=True,
        choices=["train", "eval", "inference", "preprocess", "export", "serve", "tune", "explain",
                 "analysis"],
    )
    parser.add_argument("--config", default=_DEFAULT_CONFIG)
    parser.add_argument("--exp-name", dest="exp_name", default=None)
    parser.add_argument("--output-dir", dest="output_dir", default=None)
    parser.add_argument("--input", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--format", default="torch", choices=["torch", "pt2", "stablehlo"],
                        help="export mode artifact: a reference .pth (torch) or an exported "
                        "program (pt2); the JAX package's stablehlo is refused")
    parser.add_argument("--resume", default=None)
    parser.add_argument("--pretrained", default=None,
                        help="reference torch .pth to import as initial weights")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="where every mode runs: the CUDA device (default) or the CPU")
    parser.add_argument("--num-workers", dest="num_workers", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument(
        "--model", default=None,
        choices=["swin_unetr", "unet", "unet3d", "attention_unet", "dual_encoder"],
    )
    parser.add_argument(
        "--fusion", default=None,
        choices=["early", "late", "attention", "cross_attention", "bidirectional", "suv_guided"],
    )
    parser.add_argument("--modalities", nargs="+", default=None)
    parser.add_argument("--suv-analysis", dest="suv_analysis", action="store_true")
    parser.add_argument("--tmtv-analysis", dest="tmtv_analysis", action="store_true")
    parser.add_argument("--histogram", action="store_true")
    parser.add_argument("--generate-report", dest="generate_report", action="store_true")
    parser.add_argument("--gradcam", action="store_true")
    parser.add_argument("--attention-maps", dest="attention_maps", action="store_true")
    parser.add_argument("--tsne", action="store_true")
    parser.add_argument("--port", type=int, default=None, help="HTTP port for serve mode")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--set", dest="overrides", action="append", default=None, metavar="KEY=VALUE",
        help="override any config key by dotted path (repeatable); the value is "
        "YAML-parsed, e.g. --set training.ema_decay=0.999. Keys must exist in the "
        "loaded config or the shipped default.yaml schema; prefix with + to create "
        "a new key",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--debug", action="store_true")
    return parser.parse_args(argv)


def resolve_device(name) -> torch.device:
    """``--device``: the CUDA device unless ``cpu`` is asked for; no card
    and no ``--device cpu`` raises."""
    if name in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass --device cpu to run on the CPU"
            )
        # one rank per device under torchrun: this rank's card
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local)) if local is not None else torch.device("cuda")
    return torch.device(name)


def _device(config) -> torch.device:
    return resolve_device(config.get("hardware.device", None))


def run_train(config, logger) -> None:
    from multimodal_organ_segmentation_tpu_torch.data.dataloader import get_dataloader
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    device = _device(config)
    logger.info("Starting training pipeline")
    logger.info(f"Experiment: {config.get('experiment.name')}")

    train_loader = get_dataloader(config, split="train", device=device)
    val_loader = get_dataloader(config, split="val", device=device)
    trainer = Trainer(
        config,
        train_loader=train_loader,
        val_loader=val_loader,
        logger=logger,
        resume_from=config["_args"].get("resume"),
        device=device,
    )
    trainer.train()
    logger.info("Training completed")


def run_eval(config, logger) -> None:
    from multimodal_organ_segmentation_tpu_torch.data.dataloader import (
        DataLoader,
        get_dataloader,
    )
    from multimodal_organ_segmentation_tpu_torch.data.dataset import get_dataset
    from multimodal_organ_segmentation_tpu_torch.data.transforms import get_transforms
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
    from multimodal_organ_segmentation_tpu_torch.utils.io import save_json

    ckpt = config["_args"].get("checkpoint")
    if ckpt is None:
        raise ValueError("--checkpoint is required for evaluation mode")
    # the checkpoint is self-sufficient; a model.pretrained left over from
    # the training YAML must not be required (or even read) here
    config.set("model.pretrained", None)
    device = _device(config)

    logger.info(f"Evaluating checkpoint: {ckpt}")
    native = bool(config.get("evaluation.sliding_window", False))
    if native:
        # native-grid evaluation: sliding window on the ORIGINAL grids with
        # per-class Dice + HD95 + NSD + ASSD
        dataset = get_dataset(
            config, split="test", transform=get_transforms(config, mode="native", device=device)
        )
        loader = DataLoader(
            dataset,
            batch_size=1,  # native grids vary per case; never pad-collate them
            shuffle=False,
            num_workers=int(config.get("hardware.num_workers", 4)),
        )
        trainer = Trainer(config, logger=logger, device=device)
        trainer.init_state()
        trainer.load_params(ckpt)
        metrics = trainer.evaluate_native(loader)
    else:
        test_loader = get_dataloader(config, split="test", device=device)
        trainer = Trainer(config, val_loader=test_loader, logger=logger, device=device)
        trainer.init_state()
        trainer.load_params(ckpt)
        metrics = trainer.evaluate()
    logger.info(f"Results: {metrics}")

    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import world

    if world()[0] != 0:
        # every rank holds the merged metrics: rank 0 writes them
        logger.info("Non-zero rank: metrics written by rank 0")
        return

    out = config["_args"].get("output")
    name = "eval_native.json" if native else "eval_metrics.json"
    shard_val = config.get("evaluation.case_shard", "auto")
    if native and isinstance(shard_val, (list, tuple)) and int(shard_val[1]) > 1:
        # explicit [pid, nproc]: every worker carries PARTIAL metrics — suffix
        # the slot so workers on a shared filesystem don't clobber each other
        name = f"eval_native.w{int(shard_val[0])}of{int(shard_val[1])}.json"
    metrics_path = Path(out) / name if out else trainer.output_dir / name
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    save_json(metrics, metrics_path)
    logger.info(f"Saved metrics: {metrics_path}")

    # native-grid eval: per-case table for clinical review (one row per case,
    # flattened per-class columns) next to the cohort JSON
    if metrics.get("per_case"):
        rows = metrics["per_case"]
        csv_path = metrics_path.with_name(metrics_path.stem + "_cases.csv")
        n_cls = len(rows[0]["dice_per_class"])
        cols = ["case", "dice"] + [f"dice_c{c}" for c in range(n_cls)]
        hd_key = next(k for k in rows[0] if k.startswith("hd"))
        cols += [hd_key, "surface_dice"] + [f"surface_dice_c{c}" for c in range(n_cls)]
        cols += ["assd"] + [f"assd_c{c}" for c in range(n_cls)]
        # opt-in columns (lesion detection, calibration) appear only when
        # their evaluation.* switches produced them
        opt_cols = [k for k in ("lesion_tp", "lesion_fp", "lesion_fn", "ece") if k in rows[0]]
        cols += opt_cols
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for r in rows:
                w.writerow(
                    [r["case"], r["dice"], *r["dice_per_class"], r[hd_key],
                     r["surface_dice"], *r["surface_dice_per_class"],
                     r.get("assd"), *r.get("assd_per_class", [None] * n_cls),
                     *[r.get(k) for k in opt_cols]]
                )
        logger.info(f"Saved per-case metrics: {csv_path}")


def run_inference(config, logger) -> None:
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    ckpt = config["_args"].get("checkpoint")
    input_path = config["_args"].get("input")
    output_path = config["_args"].get("output") or "outputs/predictions"
    if ckpt is None:
        raise ValueError("--checkpoint is required for inference mode")
    if input_path is None:
        raise ValueError("--input is required for inference mode")
    config.set("model.pretrained", None)
    device = _device(config)

    logger.info(f"Inference: {input_path} → {output_path}")
    trainer = Trainer(config, logger=logger, device=device)
    trainer.init_state()
    trainer.load_params(ckpt)
    trainer.predict(input_path, output_path)
    logger.info("Inference completed")


def run_preprocess(config, logger) -> None:
    """DICOM series under ``--input/{MOD}`` → NIfTI volumes and metadata
    under ``--output/{MOD}``, each resampled to its
    ``data.preprocessing.<mod>.target_spacing`` when one is set, SUV volumes
    of the PET, then registration of every modality to
    ``data.primary_modality`` (``preprocessing/``)."""
    from multimodal_organ_segmentation_tpu_torch.preprocessing import (
        DicomConverter,
        ImageRegistration,
        SUVCalculator,
    )
    from multimodal_organ_segmentation_tpu_torch.preprocessing.resample import resample_file

    input_path = config["_args"].get("input")
    output_path = config["_args"].get("output") or "data/processed"
    if input_path is None:
        raise ValueError("--input is required for preprocess mode")
    device = _device(config)

    logger.info(f"Preprocess: {input_path} → {output_path}")
    Path(output_path).mkdir(parents=True, exist_ok=True)
    converter = DicomConverter(config)
    suv_calc = SUVCalculator(config)
    registrator = ImageRegistration(config, device)

    modalities = list(config.get("data.modalities", ["CT", "PET"]))
    for modality in modalities:
        mod_in = Path(input_path) / modality
        mod_out = Path(output_path) / modality
        if mod_in.exists():
            logger.info(f"Processing {modality}")
            start = time.perf_counter()
            nifti_path = converter.convert(mod_in, mod_out, modality=modality)
            logger.info(f"{modality}: convert {time.perf_counter() - start:.3f} s")
            if nifti_path is not None:
                # spacing resample if configured (the reference declares
                # target_spacing but never applies it)
                spacing = config.get(f"data.preprocessing.{modality.lower()}.target_spacing")
                if spacing:
                    start = time.perf_counter()
                    resample_file(nifti_path, nifti_path, list(spacing), device=device)
                    logger.info(f"{modality}: resample {time.perf_counter() - start:.3f} s")
            if modality == "PET" and nifti_path is not None:
                # SUV from the converted volume + its saved metadata
                start = time.perf_counter()
                suv_calc.calculate(nifti_path, mod_out)
                logger.info(f"{modality}: suv {time.perf_counter() - start:.3f} s")

    if len(modalities) > 1 and bool(config.get("data.registration.enabled", False)):
        logger.info("Registering images")
        start = time.perf_counter()
        registrator.register(output_path, config.get("data.primary_modality", "CT"))
        logger.info(f"register {time.perf_counter() - start:.3f} s; pyramid "
                    f"{registrator.levels}")
    logger.info("Preprocessing completed")


def run_export(config, logger) -> None:
    """Export a port checkpoint to a deployment artifact.

    ``--format torch`` (default): reference-loadable ``.pth`` state dict
    (the inverse of ``--pretrained`` import). ``--format pt2``: an exported
    program (``torch.export``) with the weights baked in and a symbolic
    tile-batch dim; it serves with no model code but the port's op library.
    Both carry the weights eval and inference run on (EMA-selected)."""
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer, select_infer_params
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_json

    ckpt = config["_args"].get("checkpoint")
    out = config["_args"].get("output")
    if ckpt is None or out is None:
        raise ValueError("--checkpoint and --output are required for export mode")
    fmt = config["_args"].get("format", "torch")
    if fmt == "stablehlo":
        raise ValueError("--format stablehlo is the JAX package's artifact; the port's "
                         "portable format is --format pt2")
    config.set("model.pretrained", None)
    device = _device(config)

    trainer = Trainer(config, logger=logger, device=device)
    trainer.init_state()
    trainer.load_params(ckpt)
    meta_path = Path(ckpt) / "meta.json"
    meta = load_json(meta_path) if meta_path.exists() else {}
    epoch, best = int(meta.get("epoch", 0)), float(meta.get("best_metric", 0.0))
    if trainer.state.ema_params is not None and bool(config.get("training.ema_eval", True)):
        logger.info("checkpoint carries EMA params — exporting the EMA weights")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    if fmt == "pt2":
        from multimodal_organ_segmentation_tpu_torch.models.program_export import export_program

        # the serving model: inference weights in the compute dtype, eval mode
        model = trainer.freeze_for_inference()
        export_program(
            model,
            out,
            roi=tuple(config.get("model.backbone.img_size", [96, 96, 96])),
            in_channels=len(config.get("data.modalities", ["CT", "PET"])),
            metadata={
                "model": str(config.get("model.name", "unet3d")),
                "num_classes": int(config.get("model.out_channels", 0) or 0),
                "modalities": list(config.get("data.modalities", [])),
                "epoch": epoch,
                "best_metric": best,
            },
        )
        logger.info(f"Exported pt2 program: {out}")
        return
    from multimodal_organ_segmentation_tpu_torch.models.torch_export import export_torch_checkpoint

    export_torch_checkpoint(select_infer_params(trainer.state, config), config, out, epoch=epoch,
                            best_metric=best, history=meta.get("history", {}))
    logger.info(f"Exported torch checkpoint: {out}")


def run_serve(config, logger) -> None:
    """The resident HTTP segmentation service (``serving/server.py``)."""
    from multimodal_organ_segmentation_tpu_torch.serving import run_serve as _serve

    _serve(config, logger, device=_device(config))


def run_tune(config, logger) -> None:
    """Measure serving candidates (tile chunk size × overlap) on the device
    and write the winning profile."""
    from multimodal_organ_segmentation_tpu_torch.serving.tuner import tune_serving, write_profile

    ckpt = config["_args"].get("checkpoint")
    report = tune_serving(config, logger=logger, checkpoint=ckpt, device=_device(config))
    out = config["_args"].get("output")
    profile_path = (
        Path(out)
        if out
        else Path(config.get("experiment.output_dir", "outputs"))
        / str(config.get("experiment.name", "exp"))
        / "tuned_serving.yaml"
    )
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import world

    # every rank holds the same report; rank 0 writes it
    if world()[0] == 0:
        write_profile(report, profile_path)
    best = report["best"]
    if best is None:  # write_profile raised on rank 0; the others say why too
        raise RuntimeError(f"no eligible tuning candidate: "
                           f"{[r.get('error') for r in report['results']]}")
    logger.info(
        f"Best: overlap={best['overlap']} sw_batch={best['sw_batch']} → "
        f"{best['vol_per_min']} vol/min; profile saved: {profile_path} "
        "(apply with --set inference.batch_size=... --set "
        "inference.sliding_window.overlap=...)"
    )


def run_explain(config, logger) -> None:
    """GradCAM, attention maps, integrated gradients and t-SNE over the
    cases under ``--input`` (``explainability/runner.py``)."""
    from multimodal_organ_segmentation_tpu_torch.explainability import run_explainability

    ckpt = config["_args"].get("checkpoint")
    input_path = config["_args"].get("input")
    output_path = config["_args"].get("output") or "outputs/explain"
    if ckpt is None or input_path is None:
        raise ValueError("--checkpoint and --input are required for explain mode")
    run_explainability(config, ckpt, input_path, output_path, logger, device=_device(config))


def run_analysis(config, logger) -> None:
    """SUV, TMTV/TLG and histogram analysis of the SUV volume and
    segmentation under ``--input`` (``analysis/``), and the report."""
    from multimodal_organ_segmentation_tpu_torch.analysis import (
        HistogramAnalyzer,
        ReportGenerator,
        SUVAnalyzer,
        TMTVAnalyzer,
    )

    input_path = config["_args"].get("input")
    output_path = config["_args"].get("output") or "outputs/analysis"
    if input_path is None:
        raise ValueError("--input is required for analysis mode")
    device = _device(config)

    logger.info(f"Analysis: {input_path} → {output_path}")
    Path(output_path).mkdir(parents=True, exist_ok=True)
    results = {}
    if bool(config.get("analysis.suv.enabled", False)):
        results["suv"] = SUVAnalyzer(config, device).analyze(input_path, output_path)
    if bool(config.get("analysis.tmtv.enabled", False)):
        results["tmtv"] = TMTVAnalyzer(config, device).analyze(input_path, output_path)
    if bool(config.get("analysis.histogram.enabled", False)):
        results["histogram"] = HistogramAnalyzer(config, device).analyze(input_path, output_path)
    if config["_args"].get("generate_report", False):
        ReportGenerator(config).generate(results, output_path)
    logger.info("Analysis completed")


def main(argv=None) -> None:
    args = parse_args(argv)
    config = load_config(args.config)
    # the shipped default.yaml is the documented schema: its keys are valid
    # --set targets even when the loaded config omits them
    schema = None
    if Path(_DEFAULT_CONFIG).exists() and str(args.config) != _DEFAULT_CONFIG:
        schema = load_config(_DEFAULT_CONFIG)
    config = merge_config_with_args(config, args, schema=schema)
    # the device is settled before anything is built: no card and no
    # --device cpu stops here
    device = resolve_device(args.device)
    if device.index is not None:
        torch.cuda.set_device(device)
    # the process group of a job of several ranks comes before everything
    # else (NCCL for the card, gloo for the CPU)
    from multimodal_organ_segmentation_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed,
    )
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import world

    maybe_initialize_distributed(config, device=device)
    rank = world()[0]

    log_dir = Path(config.get("experiment.log_dir", "logs")) / str(
        config.get("experiment.name", "exp")
    )
    logger = setup_logger(
        name="main",
        log_file=str(log_dir / (f"{args.mode}.log" if rank == 0 else f"{args.mode}.rank{rank}.log")),
        level="DEBUG" if args.debug else "INFO",
    )
    set_seed(int(config.get("experiment.seed", 42)))

    logger.info(f"Mode: {args.mode}")
    logger.info(f"Config: {args.config}")

    runners = {"train": run_train, "eval": run_eval, "inference": run_inference,
               "export": run_export, "serve": run_serve, "tune": run_tune,
               "explain": run_explain, "analysis": run_analysis, "preprocess": run_preprocess}
    try:
        runners[args.mode](config, logger)
    except KeyboardInterrupt:
        logger.warning("Interrupted by user")
        sys.exit(1)
    except Exception as e:
        logger.error(f"Error: {e}", exc_info=True)
        raise
