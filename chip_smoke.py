"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; no phase's error is caught):

1. build   — compile every CUDA kernel under
   ``multimodal_organ_segmentation_tpu_torch/csrc/`` with nvcc (one
   process per source, all started together) into ``build/kernels/``;
2. kernels — at every shape the main paths give each kernel, in bf16 and
   f32, the kernel against its plain PyTorch version on the same inputs,
   with the kernel's, the plain version's and one PyTorch library call's
   time (``F.scaled_dot_product_attention`` or ``F.conv3d``, yardsticks the
   port never calls) beside the least time the card could take (``bound``:
   bytes, FLOPs or exponentials, whichever is slowest), its share of that
   bound and its ratio to the library call: the attention kernels at the
   serving shapes (forward; bf16 must take the tensor-core route ``mma``,
   f32 the ``f32`` route) and at the edge shapes of their tilings, and at
   the training shapes (forward + backward through their custom ops'
   ``register_autograd`` gradients against autograd of the plain versions), the
   convolution at its script's shapes and at the edge shapes of its
   tiling (bf16 must take the ``wgmma`` route, f32 the ``f32`` route);
3. model   — one 96³ tile through the flagship model in f32 (TF32 off) and
   in bf16, each once through the kernels and once through the plain
   versions;
4. serve   — the main path at full width: ``build_model`` of the flagship
   config (bf16, seeded init), then sliding-window inference
   (ROI 96³, overlap 0.5, Gaussian blend, 15 tiles a chunk) and
   ``predict_labels`` over one warm-up and three 192×192×256×2 volumes,
   with each kernel's launches counted per route and held to the counts
   the wrappers' plans predict (every one on ``mma``). ``--profile`` adds a
   profiler pass over one more volume and prints the device time by kernel;
5. conv    — kernel C's own path: ``scripts/proto_conv_kernel_torch.py``;
6. train   — the flagship trainer at full width (micro-batch 2 of 96³
   CT+PET patches, accumulation 4, bf16 compute on f32 master weights,
   remat, AdamW, ``dice_ce``, augmentation off): one warm-up optimiser step
   through the trainer's epoch loop and three timed ones, with the loss
   falling on the same batch, non-zero gradients on every attention
   parameter, the kernels' launches per route held to the counts the plans
   predict, a forced non-finite batch skipped bit-exactly, and one f32 step
   through the kernels against one through the plain versions.
   ``--profile`` adds a profiler pass over one train step;
7. cli     — the port's CLI (``cli.main``) on ``configs/swin_unetr_xattn_flagship.yaml``
   at full width and depth on the card, with inputs written under
   ``outputs/`` from the seed: ``--mode train`` for one epoch (one optimiser
   step, micro-batch 2 × accumulation 4 of 128×128×112 CT+PET cases resized
   to 96³ and augmented on the card, then resized-grid and native-grid
   validation), ``--mode inference`` over a 192×192×256 and a 160×176×224
   case (plain, then with the uncertainty map) with every mask held voxel
   for voxel to ``sliding_window_inference`` + ``predict_labels`` +
   postprocess on the same weights and each route's launches to the
   runner's grid, and ``--mode eval`` on native grids with the JAX CLI's
   keys and columns and per-case Dice equal to the library path's;
8. models  — the other model families at full width (``MODEL_KEYS``, each its YAML file:
   UNet3D CT 64³, UNet3D early fusion 96³, the Attention U-Net at its
   widths, the DualEncoder with cross attention at 128³ and the
   4-modality DualEncoder at 96³), seeded weights: one 128³ DualEncoder
   tile through the kernels and the plain versions in f32 and bf16; each
   configuration serves a warm-up and a timed 192×192×256 volume with its
   own modality count, kernel B's launches held to the tile grid's plan;
   the DualEncoder trains through the ``Trainer``'s epoch loop (micro-batch 1
   × accumulation 8 of 128³ patches, bf16 on f32 master weights, head
   dropout 0.1) with kernel B's launches held to the plan, gradients on
   every fusion parameter and the dropout draws following the step's key;
   then ``cli.main --mode inference`` on its YAML, the mask equal to the
   library path's. Phase 2 checks kernel B at these DualEncoder shapes too;
9. http    — the HTTP service (``serving/server.py``) on the flagship at full
   width from a port checkpoint of a seeded init: ``make_server`` on an
   OS-assigned port, ``/v1/warmup`` at 192×192×256, four ``/v1/segment``
   requests on one synthetic CT+PET case (two of them concurrent, one with
   the uncertainty map), ``/v1/stats``; every mask equal to the library
   path's voxel for voxel, kernel A's and B's launches to the plan (all
   ``mma``); then ``--mode serve`` in a process of its own: one request,
   SIGTERM, exit 0;
10. tune   — ``--mode tune`` on the flagship: 192×192×256, overlaps 0.5
   and 0.25 × chunks of 8 and 15 tiles, one timed run each; every
   candidate's volumes/min, the written profile, the launches to the plan;
11. export — ``--mode export --format pt2`` of the [http] checkpoint, the
   program loaded here and served by ``InferenceService``: its mask equal
   to the checkpoint-served one, kernels A and B launched through the
   program's custom ops as planned; then ``--format torch`` of a
   ``monai_compat`` SwinUNETR (fs 48, depths 2-2-2-2) and ``--pretrained``
   of that ``.pth``: the weights carried exactly, one 96³ tile through
   kernel A against the plain path in f32 and bf16;
12. explain — ``--mode explain``'s library calls on the flagship at full
   width from a port checkpoint of a seeded init (the card has neither
   matplotlib nor sklearn: no figure, no t-SNE embedding; the CPU tests run
   the CLI with them), over a 192×192×256 and two 128×128×112 synthetic
   CT+PET cases: GradCAM on the last perturbation point, attention saliency
   and integrated gradients on the native grids (chunks of 4 tiles,
   forward and backward through A's and B's custom ops), the capture forward
   (dense window attention, kernel B) and IG on the 96³ resize, the pooled
   t-SNE features; every map finite on its grid, each tool's wall time, the
   peak memory, A's and B's launches held to the plans (all ``mma``; the
   capture forward launches B and not A); one f32 tile's GradCAM, attention
   probabilities, input gradient and IG through the kernels against the
   plain versions, GradCAM and the input gradient shown to fail with a
   1e-4 error planted in A, and IG's sum against the midpoint sum of F's
   central differences;
13. analysis — ``--mode analysis --generate-report`` through ``cli.main`` on
   the [cli] phase's mask of the 192×192×256 case and a synthetic SUV volume
   on its grid: SUV, TMTV and TLG numbers against the same functions on CPU
   tensors, the masks equal, the CSV and XLSX columns the JAX tables';
14. preprocess — a PET/CT DICOM study written from the seed with the port's
   writer at a scanner's sizes (CT 512×512×280 of 0.9766×0.9766×2.5 mm,
   int16 with a rescale intercept; PET 192×192×214 of 4.0728×4.0728×3.27 mm
   with the SUV tags, its anatomy the CT's moved a few mm under another
   intensity map), then ``cli.main --mode preprocess`` on ``configs/default.yaml``
   (target spacing 1.5×1.5×2.0 mm, translation + Mattes MI): the CT's NIfTI
   before the resample equal to the stored pixels × slope + intercept, the
   resampled grids (333×333×350, 521×521×350) and affines equal to the
   formula, every SUV volume to ``suv_factor`` × PET within 1e-6, MI's
   translation within 0.6 voxel of the planted shift as the resampled grids
   carry it, ``pet_registered.nii.gz`` and the JAX transform JSON written,
   a label map carried through the transform (nearest, uint8) with its label
   set kept; wall s a stage, s an iteration a level, the peak memory. Then
   ``register_arrays`` at the full 333×333×350 grid for rigid, affine and
   deformable against planted transforms, held to the JAX TRE gates, and
   one ``register_arrays`` a method at 48³ on the card against the same on
   CPU tensors (final parameters within 1e-3 voxel);
15. multi  — the multi-device layer on the one card: (a) one NCCL rank on
   cuda:0 runs ``sharded_sliding_window_inference`` and the runner with a
   mesh over a 192×192×256 flagship volume at full width, both equal bit
   for bit to the one-device runner's logits, kernels A and B launched as
   the tile grid plans; (b) two processes share cuda:0 under gloo (the
   gathers and the ring's exchanges stage through the host, gloo's only
   way with CUDA tensors): the tile-sharded volume within bf16 ``TOL`` of
   (a), one data-parallel f32 train step of the flagship (micro-batch 2
   split 1 + 1) within ``STEP_RTOL`` of the one-rank step, the ring at the
   DE128 24³ level against dense attention (f32, forward and backward,
   within ``TOL``); in the same two ranks, (c) tensor parallelism on a
   ``data 1 × model 2`` mesh: a bf16 forward of 2 flagship tiles split
   against the whole model's, one f32 SGD step split against the whole
   model's (loss, grad_norm, gathered weights, and the weights' update,
   which must move a weight by ten times the weights' tolerance), kernels
   A and B launched on each rank with the plan's head counts; (d) the
   multi-rank HTTP service on a ``data 2`` mesh: rank 0 answers one
   request of the [http] case (its checkpoint and case are kept for this)
   while rank 1 follows, the mask equal to [http]'s outside near-ties of
   the one-process logits;
   (e) wall times and each rank's peak memory beside the card's name and
   power limit. No multi-GPU number: one card.

The line before the last holds one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import ast
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# The flagship's blocks of configs/swin_unetr_xattn_flagship.yaml, as a
# dict: the card's machine needs no PyYAML. A CPU test holds the ``model``,
# ``inference``, ``training``, ``parallel`` and ``data.augmentation`` blocks
# equal to the file's.
FLAGSHIP = {
    "experiment": {"name": "swin_xattn_flagship", "seed": 42},
    "data": {
        "modalities": ["CT", "PET"],
        "augmentation": {"enabled": True, "random_flip": True, "random_rotate": 15,
                         "random_intensity": 0.1},
    },
    "model": {
        "name": "swin_unetr",
        "in_channels": 2,
        "out_channels": 8,
        "backbone": {
            "img_size": [96, 96, 96],
            "feature_size": 48,
            "depths": [2, 2, 2, 2],
            "num_heads": [3, 6, 12, 24],
            "window_size": [6, 6, 6],
            "scan_blocks": True,
        },
        "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
        "head": {"type": "conv", "dropout": 0.0},
    },
    "inference": {
        "sliding_window": {"roi_size": [96, 96, 96], "overlap": 0.5, "mode": "gaussian"},
        "batch_size": 15,
        "shape_bucketing": True,
        "data_parallel": True,
    },
    "training": {
        "epochs": 300,
        "batch_size": 2,
        "accumulation_steps": 4,
        "optimizer": {"name": "adamw", "lr": 1.0e-4, "weight_decay": 1.0e-5},
        "scheduler": {"name": "cosine", "warmup_epochs": 10, "min_lr": 1.0e-6},
        "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5},
        "early_stopping": {"enabled": True, "patience": 30, "metric": "val_dice", "mode": "max"},
        "checkpoint": {"save_best": True, "save_last": True, "save_every": 10,
                       "save_every_steps": 500},
    },
    "parallel": {"mesh": {"data": -1, "model": 1}, "remat": True, "multihost": "auto"},
    "hardware": {"mixed_precision": "bf16"},
}
VOLUME = (192, 192, 256)
N_VOLUMES = 3
FLAGSHIP_YAML = "configs/swin_unetr_xattn_flagship.yaml"
CLI_CASE = (128, 128, 112)  # synthetic train/val/test cases of the [cli] phase
CLI_SPLITS = (8, 2, 2)  # one optimiser step of 2 x 4; 2 val and 2 test cases
CLI_VOLUMES = {"flagship": VOLUME, "other": (160, 176, 224)}  # inference cases, two buckets
# the columns the JAX CLI's native eval writes (multimodal_organ_segmentation_tpu/cli.py:200-214)
EVAL_KEYS = ("dice", "dice_per_class", "hd95", "hd95_std", "surface_dice", "surface_dice_per_class",
             "surface_dice_tolerance_mm", "assd", "assd_per_class", "num_cases", "per_case")
TRAIN_STEPS = 3  # timed optimiser steps, after one warm-up step
EMA_DECAY = 0.999  # for the skipped-step check only: the flagship trains without EMA


def train_config(mixed_precision="bf16", accumulation_steps=None):
    """The flagship as this script trains it: augmentation off (the
    transform graph is not ported yet), non-finite steps reported, one
    device (the file's ``mesh.data: -1`` means all devices of a mesh)."""
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["data"]["augmentation"]["enabled"] = False
    cfg["training"]["skip_nonfinite_updates"] = True
    cfg["hardware"]["mixed_precision"] = mixed_precision
    if accumulation_steps is not None:
        cfg["training"]["accumulation_steps"] = accumulation_steps
    return cfg


# The models phase's configurations, each configs/<key>.yaml as the port's
# load_config reads it (``model_config``). No YAML ships an Attention U-Net:
# it takes unet3d_earlyfusion_96's file under its own model name.
DE128 = "dual_encoder_xattn_128"
MODEL_KEYS = ("unet3d_ct_64", "unet3d_earlyfusion_96", "attention_unet", DE128, "full_pipeline_4mod")


def model_config(key: str) -> dict:
    from multimodal_organ_segmentation_tpu_torch.utils.config import load_config

    source = "unet3d_earlyfusion_96" if key == "attention_unet" else key
    cfg = load_config(Path(__file__).resolve().parent / "configs" / f"{source}.yaml").to_dict()
    if key == "attention_unet":
        cfg["model"]["name"] = "attention_unet"
    return cfg


DE128_YAML = f"configs/{DE128}.yaml"
DE_HEADS = 4  # the DualEncoder's cross_attn_heads: its builder keeps the default
MODELS_TRAIN_STEPS = 2  # timed DualEncoder optimiser steps, after one warm-up step


def dual_encoder_flash_shapes(cfg: dict, tiles: int):
    """Kernel B's launches for one forward of the DualEncoder of ``cfg`` over
    a batch of ``tiles`` tiles: (level, B, N, heads, head dim) for each
    pyramid level whose voxel tokens fit in ``max_tokens`` (the levels above
    it fuse by addition)."""
    model = cfg["model"]
    features = model["backbone"]["features"]
    budget = model["fusion"].get("max_tokens", 16384)
    for level, c in enumerate(features):
        n = math.prod(s // 2**level for s in model["backbone"]["img_size"])
        if model["fusion"]["type"] == "cross_attention" and n <= budget:
            yield level, tiles, n, DE_HEADS, c // DE_HEADS


# Published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, and the exponentials of the
# special-function units (16 a clock per SM, 132 SMs, 1.98 GHz).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
EXP_S = 16 * 132 * 1.98e9
SPIN_CYCLES = 200_000  # the card's spin before each timed call: about 0.1 ms at 1.98 GHz
SPIN_CYCLES_MAX = 256 * SPIN_CYCLES  # gpu_time doubles the spin up to this (about 25 ms), then fails

# |kernel - plain| limits. f32: both sum in f32 in another order and the
# kernel uses the fast exponential (a few ulp); outputs are O(1). bf16: both
# round an f32 result to bf16, so they may differ by one bf16 ulp (2**-7 at
# |x| < 2, 2**-6 below 4); the JAX package's own bf16 tests use 2e-2.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
STEP_RTOL = 1e-4  # f32 train step, kernels against plain: loss and grad_norm, relative
MODEL_TOL = 1e-3  # f32 logits after ~40 layers, each off by ~1e-6 relative
# bf16 logits, kernels against plain versions: both paths round every
# activation to bf16 (2**-9 relative), and they round in different places
# inside attention (the plain bf16 path rounds scores, bias and
# probabilities to bf16, the kernels keep them in f32 and round P only for
# P.V), so each of the ~40 layers differs by a few bf16 ulp; the logits are
# O(1). 0.25 absolute is about 30 ulp at |logit| < 2.
MODEL_TOL_BF16 = 0.25


def o1_scale(n: int) -> float:
    """Factor for unit-normal v in a check of attention over n unit-normal
    keys that keeps the outputs O(1), as ``TOL`` needs. One query's softmax
    weights have a sum of squares of about e/n, so its outputs have a
    standard deviation of about sqrt(e/n): 0.026 at the DualEncoder's 4096
    tokens and 0.014 at 13824, below the bf16 limit itself. Times this
    factor it is about 1/4, as at the flagship's /32 stage (n = 27), and
    |out| stays below 2, where one bf16 ulp is 2**-7."""
    return 0.25 * math.sqrt(n / math.e)


OUT_STD_MIN = 0.1  # a check whose reference varies less than this could not tell a wrong kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_time(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, each after the L2 is
    overwritten (the main path finds the kernel's inputs cold) and a spin of
    the card: the host dispatches ``fn`` (the attention wrappers are custom
    ops, about 70 us of host time a call) while the card is still busy, so,
    as on the main path where the host runs ahead, the dispatch falls
    outside the timed events. A call that the card reached before the host
    had queued all of it (the start event already passed once ``fn``
    returns) is not counted: the spin doubles and the call is timed again,
    and past ``SPIN_CYCLES_MAX`` the run fails."""
    import torch

    fn()  # warm-up
    spin, times = SPIN_CYCLES, []
    while len(times) < reps:
        flush.zero_()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        late = start.query()
        end.record()
        end.synchronize()
        if not late:
            times.append(start.elapsed_time(end))
        elif spin < SPIN_CYCLES_MAX:
            spin *= 2
        else:
            raise RuntimeError(f"gpu_time: the host still dispatched {fn} after a spin of "
                               f"{spin} cycles")
    return sum(times) / reps


def bound(nbytes: float, flops: float, exps: float, dtype: str) -> tuple:
    """The least ms the card could take: the largest of the bytes over HBM's
    rate, the FLOPs over the peak of their type and the exponentials over
    the special-function units' rate. Returns (ms, "bytes" or "operations",
    the limit that sets it)."""
    limits = {"bytes": nbytes / HBM_BYTES_S * 1e3,
              f"{dtype} FLOPs": flops / PEAK_FLOPS[dtype] * 1e3,
              "exponentials": exps / EXP_S * 1e3}
    limit = max(limits, key=limits.get)
    return limits[limit], ("bytes" if limit == "bytes" else "operations"), limit


def phase_build() -> None:
    from multimodal_organ_segmentation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} of {len(_build.SOURCES)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {entry}: {line.strip()}")


def window_shapes(tiles=None):
    """Kernel A's launches for one batch of ``tiles`` 96³ tiles (default: a
    serving chunk of 15): (stage, BW, heads, nW per tile or None, grid,
    window) for each Swin block, unshifted then shifted."""
    model = FLAGSHIP["model"]["backbone"]
    tiles = tiles or FLAGSHIP["inference"]["batch_size"]
    grid = model["img_size"][0] // 2
    win = model["window_size"][0]
    for stage, heads in enumerate(model["num_heads"]):
        w = min(win, grid)
        nw = (grid // w) ** 3
        for block in range(model["depths"][stage]):
            shifted = block % 2 == 1 and w < grid
            yield stage, tiles * nw, heads, (nw if shifted else None), grid, w
        grid //= 2


def flash_shapes(tiles=None):
    """Kernel B's launches for one batch of ``tiles`` tiles (default: a
    serving chunk): (stage, B, N, heads, head dim)."""
    model = FLAGSHIP["model"]
    fs = model["backbone"]["feature_size"]
    tiles = tiles or FLAGSHIP["inference"]["batch_size"]
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import _divisor_heads

    for stage in model["fusion"]["stages"]:
        c = fs * 2 ** (stage + 1)
        grid = model["backbone"]["img_size"][0] // 2 ** (stage + 2)
        heads = _divisor_heads(c, 96)
        yield stage, tiles, grid**3, heads, c // heads


def predicted_launches(tiles: int, window_repeat: int, flash_repeat: int) -> dict:
    """Each route's launches of kernels A and B when every window attention
    of a batch of ``tiles`` tiles runs ``window_repeat`` times and every
    fusion ``flash_repeat`` times, by the routes the wrappers' own plans
    give the flagship's bf16 shapes."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as fa
    from multimodal_organ_segmentation_tpu_torch.ops import window_attention as wa

    counts = {"window_attention": dict.fromkeys(wa.ROUTES, 0),
              "flash_attention": dict.fromkeys(fa.ROUTES, 0)}
    for _, bw, heads, nw, _, w in window_shapes(tiles):
        route = wa.plan(bw, w**3, heads, 16, nw or 1, torch.bfloat16)["route"]
        counts["window_attention"][route] += window_repeat
    for _, b, n, heads, d in flash_shapes(tiles):
        counts["flash_attention"][fa.plan(b, n, n, heads, d, torch.bfloat16)["route"]] += flash_repeat
    return counts


def launch_count(counts) -> int:
    """A wrapper's launches: an int, or the sum over its routes."""
    return sum(counts.values()) if isinstance(counts, dict) else counts


def reset_launches(*wrappers) -> None:
    """Set every route's count of the kernel wrappers to 0."""
    for fn in wrappers:
        fn.launches = dict.fromkeys(fn.launches, 0)


# Edge shapes of the kernels' tilings, checked against the plain versions in
# bf16 and f32 (not timed). Kernel A: (window edge, grid edge, heads, tiles,
# shifted): 3³ and 7³ windows, a batch of one and of two tiles. Kernel B:
# (B, Nq, Nk, H, D): key counts that are no multiple of 64, Nq != Nk, head
# dims 16 to 128, a single key.
WINDOW_EDGES = [(3, 6, 3, 2, True), (3, 6, 3, 1, False), (7, 14, 3, 1, True),
                (7, 14, 3, 2, False), (6, 48, 3, 1, True), (6, 12, 12, 2, True)]
FLASH_EDGES = [(2, 216, 27, 4, 96), (2, 27, 216, 4, 96), (2, 1728, 216, 2, 96),
               (2, 100, 300, 2, 16), (2, 300, 100, 2, 32), (2, 129, 65, 2, 64),
               (1, 64, 1000, 1, 128), (1, 5, 1, 1, 16)]
# Kernel C: (x shape, Cout). D/H/W below, not a multiple of and one past the
# 8-voxel tile, and a one-voxel axis; C = 8, 24, 40 (not multiples of the
# 16-channel stage); Cout = 8, 56, 104 (not multiples of the 48-channel
# block); batches of 1 and 3; and one shape of whole tiles and blocks.
CONV_EDGES = [((1, 5, 7, 3, 8), 8), ((3, 9, 9, 9, 24), 56), ((1, 1, 12, 17, 40), 104),
              ((3, 16, 8, 1, 8), 56), ((1, 10, 1, 20, 24), 8), ((2, 8, 16, 24, 16), 96)]


def window_inputs(rng, dev, dtype, bw, n, heads, grid, w, shifted, requires_grad=False):
    """Kernel A's inputs as the model hands them over: q, k, v strided views
    of one qkv tensor, an f32 bias, the shift mask of a (grid, window) layer
    or None; and the qkv tensor itself."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import _shift_attention_mask

    qkv = torch.from_numpy(rng.standard_normal((bw, n, 3, heads, 16), np.float32))
    qkv = qkv.to(dev, dtype).requires_grad_(requires_grad)
    bias = torch.from_numpy(0.5 * rng.standard_normal((heads, n, n), np.float32))
    bias = bias.to(dev).requires_grad_(requires_grad)
    mask = _shift_attention_mask((grid,) * 3, (w,) * 3, (w // 2,) * 3, dev) if shifted else None
    q, k, v = qkv.unbind(2)
    return q, k, v, bias, mask, qkv


def phase_kernels(flush) -> dict:
    import torch
    import torch.nn.functional as F

    from multimodal_organ_segmentation_tpu_torch.ops.attention import blockwise_attention
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import (
        dense_window_mha,
        window_mha,
    )

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    summary = {
        "window_attention": dict(route="cuda",
                                 source="multimodal_organ_segmentation_tpu_torch/csrc/window_attention.cu",
                                 replaces="multimodal_organ_segmentation_tpu/ops/pallas/window_attention.py:28"),
        "flash_attention": dict(route="cuda",
                                source="multimodal_organ_segmentation_tpu_torch/csrc/flash_attention.cu",
                                replaces="multimodal_organ_segmentation_tpu/ops/pallas/flash_attention.py:34"),
        "conv3x3x3": dict(route="cuda",
                          source="multimodal_organ_segmentation_tpu_torch/csrc/conv3x3x3.cu",
                          replaces="scripts/proto_conv_kernel.py:33"),
    }
    for s in summary.values():
        s.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 _bytes=0.0, _ops=0.0, _exps=0.0)

    def routed(fn, call):
        """Run ``call`` and return the route its one launch took."""
        before = dict(fn.launches)
        call()
        taken = [r for r in fn.launches if fn.launches[r] != before[r]]
        if len(taken) != 1 or fn.launches[taken[0]] != before[taken[0]] + 1:
            raise SystemExit(f"one call launched {fn.launches} from {before}")
        return taken[0]

    def record(name, dtype, err, ms, plain_ms, lib_ms, nbytes, flops, exps, extra):
        t_bound, by, limit = bound(nbytes, flops, exps, dtype)
        ok = err <= TOL[dtype]
        log(f"[kernels] {name} {extra} {dtype}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {t_bound:.4f} "
            f"({by}: {limit}) {100 * t_bound / ms:.1f}% of bound, {ms / lib_ms:.2f}x library "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} {extra} {dtype} disagrees with its plain version")
        if dtype == "bfloat16":  # the main path's type: one chunk's launches
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["library_ms"] += lib_ms
            s["_bytes"] += nbytes
            s["_ops"] += flops
            s["_exps"] += exps

    def check_edge(name, dname, route, want, err, extra):
        ok = err <= TOL[dname] and route == want
        log(f"[kernels] {name} edge {extra} {dname}: route {route} max_abs_err {err:.3e} "
            f"(tol {TOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} edge {extra} {dname}: route {route} (want {want}) or "
                             "disagrees with its plain version")

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        want = "mma" if dtype == torch.bfloat16 else "f32"
        elt = torch.finfo(dtype).bits // 8
        for stage, bw, heads, nw, grid, w in window_shapes():
            n, d = w**3, 16
            q, k, v, bias, mask, _ = window_inputs(rng, dev, dtype, bw, n, heads, grid, w, nw is not None)
            nw_arg = nw or 1
            outs = []
            route = routed(window_mha, lambda: outs.append(window_mha(q, k, v, bias, mask, nw_arg)))
            ref = dense_window_mha(q, k, v, bias, mask, nw_arg)
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs().max().item()
            del ref, outs
            if route != want:
                raise SystemExit(f"window_attention stage {stage} {dname} took route {route}")
            ms = gpu_time(lambda: window_mha(q, k, v, bias, mask, nw_arg), 10, flush)
            plain_ms = gpu_time(lambda: dense_window_mha(q, k, v, bias, mask, nw_arg), 3, flush)
            add = bias[None] if mask is None else (mask[:, None] + bias[None])
            add = add.to(dtype).repeat(bw // add.shape[0], 1, 1, 1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add), 5, flush)
            del add, qt, kt, vt
            nbytes = 4 * bw * n * heads * d * elt + heads * n * n * 4 + (nw * n * n * 4 if nw else 0)
            flops = 4 * bw * heads * n * n * d
            exps = bw * heads * n * n
            record("window_attention", dname, err, ms, plain_ms, lib_ms, nbytes, flops, exps,
                   f"stage {stage} BW={bw} N={n} H={heads} D={d} mask={'yes' if nw else 'no'} "
                   f"route {route}")
        for w, grid, heads, tiles, shifted in WINDOW_EDGES:
            n, nw = w**3, (grid // w) ** 3
            q, k, v, bias, mask, _ = window_inputs(rng, dev, dtype, tiles * nw, n, heads, grid, w, shifted)
            nw_arg = nw if shifted else 1
            outs = []
            route = routed(window_mha, lambda: outs.append(window_mha(q, k, v, bias, mask, nw_arg)))
            ref = dense_window_mha(q, k, v, bias, mask, nw_arg)
            err = (outs[0].float() - ref.float()).abs().max().item()
            check_edge("window_attention", dname, route, want, err,
                       f"N={n} tiles={tiles} nW={nw} H={heads} mask={'yes' if shifted else 'no'}")
        for stage, b, n, heads, d in flash_shapes():
            q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), np.float32)).to(dev, dtype)
                       for _ in range(3))
            outs = []
            route = routed(flash_attention, lambda: outs.append(flash_attention(q, k, v)))
            ref = blockwise_attention(q, k, v, kv_block=2048)
            torch.cuda.synchronize()
            err = (outs[0].float() - ref.float()).abs().max().item()
            del outs, ref
            if route != want:
                raise SystemExit(f"flash_attention /{2 ** (stage + 2)} {dname} took route {route}")
            ms = gpu_time(lambda: flash_attention(q, k, v), 10, flush)
            plain_ms = gpu_time(lambda: blockwise_attention(q, k, v, kv_block=2048), 3, flush)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5, flush)
            nbytes = 4 * b * n * heads * d * elt
            flops = 4 * b * heads * n * n * d
            exps = b * heads * n * n
            record("flash_attention", dname, err, ms, plain_ms, lib_ms, nbytes, flops, exps,
                   f"/{2 ** (stage + 2)} B={b} N={n} H={heads} D={d} route {route}")
        for b, nq, nk, heads, d in FLASH_EDGES:
            q = torch.from_numpy(rng.standard_normal((b, nq, heads, d), np.float32)).to(dev, dtype)
            k, v = (torch.from_numpy(rng.standard_normal((b, nk, heads, d), np.float32)).to(dev, dtype)
                    for _ in range(2))
            outs = []
            route = routed(flash_attention, lambda: outs.append(flash_attention(q, k, v)))
            ref = blockwise_attention(q, k, v, kv_block=2048)
            err = (outs[0].float() - ref.float()).abs().max().item()
            check_edge("flash_attention", dname, route, want, err,
                       f"B={b} Nq={nq} Nk={nk} H={heads} D={d}")
    summary["flash_attention"]["models_shapes"] = kernels_models(routed, flush)
    kernels_conv(record, routed, check_edge, flush)
    kernels_train(summary, flush)
    for s in summary.values():
        s["bound_ms"], s["bound_by"], s["bound_limit"] = bound(
            s.pop("_bytes"), s.pop("_ops"), s.pop("_exps"), "bfloat16")
        s["bound_pct"] = 100 * s["bound_ms"] / s["ms"]
        s["x_library"] = s["ms"] / s["library_ms"]
        log(f"[kernels] {s['source'].rsplit('/', 1)[1]} bf16 total: ms {s['ms']:.4f} bound_ms "
            f"{s['bound_ms']:.4f} ({s['bound_by']}: {s['bound_limit']}) {s['bound_pct']:.1f}% of "
            f"bound, library_ms {s['library_ms']:.4f}, {s['x_library']:.2f}x library")
    torch.cuda.empty_cache()
    return summary


def kernels_models(routed, flush) -> list:
    """Kernel B at the DualEncoder's serving shapes: each attending level of
    the 128³ DualEncoder (2 tiles a chunk) and of the 4-modality one (4 tiles
    a chunk), in bf16 (route ``mma``) and f32 (route ``f32``), against its
    plain version, with the kernel's, the plain version's and
    ``F.scaled_dot_product_attention``'s ms beside the bound. v is scaled by
    ``o1_scale(N)`` so that the outputs are O(1), and the reference's
    standard deviation is held above ``OUT_STD_MIN``. One row per shape and
    type."""
    import torch
    import torch.nn.functional as F

    from multimodal_organ_segmentation_tpu_torch.ops.attention import blockwise_attention
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        want = "mma" if dtype == torch.bfloat16 else "f32"
        elt = torch.finfo(dtype).bits // 8
        for key in (DE128, "full_pipeline_4mod"):
            cfg = model_config(key)
            for level, b, n, heads, d in dual_encoder_flash_shapes(cfg, cfg["inference"]["batch_size"]):
                q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), np.float32)
                                            * (o1_scale(n) if i == 2 else 1.0)).to("cuda", dtype)
                           for i in range(3))
                outs = []
                route = routed(flash_attention, lambda: outs.append(flash_attention(q, k, v)))
                ref = blockwise_attention(q, k, v, kv_block=2048)
                torch.cuda.synchronize()
                err = (outs[0].float() - ref.float()).abs().max().item()
                std = ref.float().std().item()
                del outs, ref
                ms = gpu_time(lambda: flash_attention(q, k, v), 10, flush)
                plain_ms = gpu_time(lambda: blockwise_attention(q, k, v, kv_block=2048), 3, flush)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5, flush)
                t_bound, by, limit = bound(4 * b * n * heads * d * elt, 4 * b * heads * n * n * d,
                                           b * heads * n * n, dname)
                ok = err <= TOL[dname] and route == want and std >= OUT_STD_MIN
                log(f"[kernels] flash_attention {key} level {level} B={b} N={n} H={heads} D={d} "
                    f"{dname} route {route}: max_abs_err {err:.3e} (tol {TOL[dname]:.0e}, reference "
                    f"std {std:.3f}, at least {OUT_STD_MIN}) ms {ms:.4f} "
                    f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {t_bound:.4f} ({by}: "
                    f"{limit}) {100 * t_bound / ms:.1f}% of bound, {ms / lib_ms:.2f}x library "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash_attention {key} level {level} {dname}: route {route} "
                                     f"(want {want}), reference std {std:.3f} or disagrees with its "
                                     "plain version")
                rows.append(dict(config=key, level=level, shape=[b, n, heads, d], dtype=dname,
                                 route=route, max_abs_err=err, out_std=std, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=t_bound, bound_by=by,
                                 bound_pct=100 * t_bound / ms, x_library=ms / lib_ms))
                del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def kernels_conv(record, routed, check_edge, flush) -> None:
    """Kernel C against ``conv3x3x3_plain`` at its script's three shapes and
    at the edge shapes of its tiling (``CONV_EDGES``, not timed), each in
    bf16 (route ``wgmma``) and f32 (route ``f32``). The weights are scaled
    so that the outputs stay below 2, where one bf16 ulp is 7.8e-3 and the
    absolute bf16 tolerance of 2e-2 means two ulp."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, conv3x3x3_plain
    from scripts.proto_conv_kernel_torch import (
        BATCH,
        SHAPE_F32,
        SHAPES_BF16,
        library_conv,
        make_inputs,
    )

    want = {torch.bfloat16: "wgmma", torch.float32: "f32"}
    cases = [(*SHAPE_F32, torch.float32)]
    cases += [((BATCH, 96, 96, 96, cin), cout, torch.bfloat16) for cin, cout in SHAPES_BF16]
    for shape, cout, dtype in cases:
        dname = str(dtype).split(".")[1]
        cin = shape[-1]
        x, w = make_inputs(shape, cout, dtype, 2, 0.3 / math.sqrt(27 * cin))
        outs = []
        route = routed(conv3x3x3, lambda: outs.append(conv3x3x3(x, w)))
        torch.cuda.synchronize()
        ref = conv3x3x3_plain(x, w)
        err = (outs[0].float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        del outs, ref
        if route != want[dtype]:
            raise SystemExit(f"conv3x3x3 {list(shape)} -> {cout} {dname} took route {route}")
        ms = gpu_time(lambda: conv3x3x3(x, w), 5, flush)
        plain_ms = gpu_time(lambda: conv3x3x3_plain(x, w), 2, flush)
        lib_ms = gpu_time(lambda: library_conv(x, w), 5, flush)
        voxels = math.prod(shape[:4])
        elt = torch.finfo(dtype).bits // 8
        nbytes = (voxels * (cin + cout) + 27 * cin * cout) * elt
        flops = 2 * 27 * voxels * cin * cout
        record("conv3x3x3", dname, err, ms, plain_ms, lib_ms, nbytes, flops, 0,
               f"x {list(shape)} -> {cout} max |out| {top:.2f} route {route}")
        del x, w
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for shape, cout in CONV_EDGES:
            x, w = make_inputs(shape, cout, dtype, 3, 0.3 / math.sqrt(27 * shape[-1]))
            outs = []
            route = routed(conv3x3x3, lambda: outs.append(conv3x3x3(x, w)))
            err = (outs[0].float() - conv3x3x3_plain(x, w).float()).abs().max().item()
            check_edge("conv3x3x3", dname, route, want[dtype], err, f"x {list(shape)} -> {cout}")
    torch.cuda.empty_cache()


def grad_time(forward, inputs, grad_out, reps: int, flush) -> float:
    """Mean device ms of the backward of ``forward()`` w.r.t. ``inputs``; the
    forward that builds the graph is not timed."""
    import torch

    total = 0.0
    for rep in range(reps + 1):  # the first is the warm-up
        out = forward()
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, inputs, grad_out)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if rep else 0.0
    return total / reps


def kernels_train(summary, flush) -> None:
    """Kernels A and B at the shapes one training micro-batch (2 tiles)
    gives them: forward and backward through their ``autograd.Function``s
    against autograd of the plain versions, outputs and the gradients of q,
    k, v (and the bias for A). Gradient tolerances are the forward's times
    the largest reference gradient (at least 1): the bias gradient sums over
    every window. The backward is the plain version's gradient on the saved
    inputs, so its time is the plain version's forward + backward."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.attention import blockwise_attention
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import (
        dense_window_mha,
        window_mha,
    )

    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    micro = FLAGSHIP["training"]["batch_size"]
    for s in (summary["window_attention"], summary["flash_attention"]):
        s.update(train_fwd_ms=0.0, train_bwd_ms=0.0, train_grad_max_abs_err=0.0)

    def compare(name, dname, extra, out, ref, grads, ref_grads, fwd_ms, bwd_ms, into_summary=True):
        err = (out.float() - ref.float()).abs().max().item()
        gerr, ok = 0.0, err <= TOL[dname]
        for g, r in zip(grads, ref_grads):
            e = (g.float() - r.float()).abs().max().item()
            gerr = max(gerr, e)
            ok = ok and e <= TOL[dname] * max(1.0, r.float().abs().max().item())
        log(f"[kernels] {name} train {extra} {dname}: out max_abs_err {err:.3e} grad "
            f"max_abs_err {gerr:.3e} fwd_ms {fwd_ms:.4f} bwd_ms {bwd_ms:.4f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} {extra} {dname}: forward or gradients disagree with "
                             "autograd of the plain version")
        if dname == "bfloat16" and into_summary:
            s = summary[name]
            s["train_fwd_ms"] += fwd_ms
            s["train_bwd_ms"] += bwd_ms
            s["train_grad_max_abs_err"] = max(s["train_grad_max_abs_err"], gerr)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for stage, bw, heads, nw, grid, w in window_shapes(micro):
            n, d = w**3, 16
            q, k, v, bias, mask, qkv = window_inputs(rng, dev, dtype, bw, n, heads, grid, w,
                                                     nw is not None, requires_grad=True)
            nw_arg = nw or 1
            out = window_mha(q, k, v, bias, mask, nw_arg)
            go = torch.from_numpy(rng.standard_normal(tuple(out.shape), np.float32)).to(dev, dtype)
            grads = torch.autograd.grad(out, [qkv, bias], go)
            ref = dense_window_mha(q, k, v, bias, mask, nw_arg)
            ref_grads = torch.autograd.grad(ref, [qkv, bias], go)
            torch.cuda.synchronize()
            with torch.no_grad():
                fwd_ms = gpu_time(lambda: window_mha(q, k, v, bias, mask, nw_arg), 10, flush)
            bwd_ms = grad_time(lambda: window_mha(q, k, v, bias, mask, nw_arg), [qkv, bias], go,
                               5, flush)
            compare("window_attention", dname,
                    f"stage {stage} BW={bw} N={n} H={heads} D={d} mask={'yes' if nw else 'no'}",
                    out, ref, grads, ref_grads, fwd_ms, bwd_ms)
        de_cfg = model_config(DE128)
        de_micro = de_cfg["training"]["batch_size"]
        flash = [(f"/{2 ** (stage + 2)}", b, n, heads, d, True)
                 for stage, b, n, heads, d in flash_shapes(micro)]
        flash += [(f"{DE128} level {level}", b, n, heads, d, False)
                  for level, b, n, heads, d in dual_encoder_flash_shapes(de_cfg, de_micro)]
        for where, b, n, heads, d, flagship in flash:
            # the DualEncoder's token counts need v scaled for O(1) outputs
            scales = (1.0, 1.0, 1.0 if flagship else o1_scale(n))
            q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), np.float32) * c)
                       .to(dev, dtype).requires_grad_() for c in scales)
            out = flash_attention(q, k, v)
            go = torch.from_numpy(rng.standard_normal(tuple(out.shape), np.float32)).to(dev, dtype)
            grads = torch.autograd.grad(out, [q, k, v], go)
            ref = blockwise_attention(q, k, v, kv_block=2048)
            ref_grads = torch.autograd.grad(ref, [q, k, v], go)
            torch.cuda.synchronize()
            extra = f"{where} B={b} N={n} H={heads} D={d}"
            if not flagship:
                std = ref.float().std().item()
                extra += f" reference std {std:.3f}"
                if std < OUT_STD_MIN:
                    raise SystemExit(f"flash_attention train {extra}: below {OUT_STD_MIN}")
            with torch.no_grad():
                fwd_ms = gpu_time(lambda: flash_attention(q, k, v), 10, flush)
            bwd_ms = grad_time(lambda: flash_attention(q, k, v), [q, k, v], go, 5, flush)
            compare("flash_attention", dname, extra, out, ref, grads, ref_grads, fwd_ms, bwd_ms,
                    into_summary=flagship)


def check_model(what: str, cfg: dict, x) -> None:
    """One tile ``x`` through the model of ``cfg``, through the kernels and
    through the plain versions: in f32 (TF32 off) and in bf16, the serving
    type. Labels must agree on every voxel whose top-2 logit margin is above
    twice the logit tolerance."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tile = "x".join(str(s) for s in x.shape[1:4])
    for precision, tol in (("fp32", MODEL_TOL), ("bf16", MODEL_TOL_BF16)):
        cfg = json.loads(json.dumps(cfg))
        cfg["hardware"]["mixed_precision"] = precision
        model = build_model(cfg)
        with torch.no_grad():
            kern = model(x).float()
            set_use_kernels(model, False)
            plain = model(x).float()
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        top2 = plain.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
        same = kern.argmax(-1) == plain.argmax(-1)
        agree, agree_clear = same.float().mean().item(), same[clear].all().item()
        log(f"[model] {what} {precision}, one {tile} tile: max |logit kernels - plain| {err:.3e} "
            f"(tol {tol:.0e}; largest |logit| {plain.abs().max().item():.2f}), label agreement "
            f"{agree:.6f}, all labels agree where the top-2 margin > {2 * tol:.0e} "
            f"({clear.float().mean().item():.4f} of voxels): {agree_clear}")
        if not (torch.isfinite(kern).all() and err <= tol and agree_clear):
            raise SystemExit(f"the {precision} {what} model through the kernels disagrees with "
                             "the plain versions")
        del model, kern, plain
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_model() -> None:
    """One 96³ tile through the flagship model (``check_model``)."""
    import torch

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 96, 96, 96, 2), np.float32)).cuda()
    check_model("flagship", FLAGSHIP, x)


def profile_device_time(fn, what: str) -> None:
    """Run ``fn`` (which ends in a synchronise) under the profiler and print
    the device time by kernel, top 25. Device-side rows only: the CPU
    operators' rows repeat their kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                    key=lambda e: -device_us(e))
    total = sum(device_us(e) for e in events)
    if not total:
        log(f"[profile] {what}: the profiler recorded no device time: not measured")
        return
    log(f"[profile] {what}: device time {total / 1e3:.1f} ms over {wall_ms:.1f} ms of "
        f"wall time under the profiler (busy {100 * total / 1e3 / wall_ms:.1f}%), by kernel (top 25):")
    for e in events[:25]:
        t = device_us(e)
        log(f"[profile]   {t / 1e3:9.2f} ms {100 * t / total:5.1f}% x{e.count:<5d} {e.key[:90]}")


def phase_serve(profile: bool) -> dict:
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        predict_labels,
        sliding_window_inference,
        tile_count,
    )
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

    torch.cuda.reset_peak_memory_stats()
    model = build_model(FLAGSHIP)
    sw_cfg = FLAGSHIP["inference"]["sliding_window"]
    roi, overlap, mode = tuple(sw_cfg["roi_size"]), sw_cfg["overlap"], sw_cfg["mode"]
    sw_batch = FLAGSHIP["inference"]["batch_size"]
    classes = FLAGSHIP["model"]["out_channels"]

    def run_sw(v):
        return sliding_window_inference(v, model, roi, classes, overlap, sw_batch, mode)

    def serve(vol):
        labels, probs = predict_labels(run_sw, vol, return_probs=True)
        torch.cuda.synchronize()
        return labels, probs

    rng = np.random.default_rng(FLAGSHIP["experiment"]["seed"])
    volumes = [torch.from_numpy(rng.standard_normal((*VOLUME, 2), np.float32)).cuda()
               for _ in range(N_VOLUMES + 1)]
    chunks = math.ceil(tile_count(VOLUME, roi, overlap) / sw_batch)
    passes = chunks * (N_VOLUMES + 1)
    expect = predicted_launches(sw_batch, passes, passes)
    if any(counts["f32"] for counts in expect.values()):
        raise SystemExit(f"a flagship bf16 attention is planned off the tensor-core route: {expect}")

    reset_launches(window_mha, flash_attention)
    t0 = time.perf_counter()
    serve(volumes[0])
    log(f"[serve] warm-up volume {(time.perf_counter() - t0) * 1e3:.1f} ms")
    times = []
    for vol in volumes[1:]:
        t0 = time.perf_counter()
        labels, probs = serve(vol)
        times.append((time.perf_counter() - t0) * 1e3)
        ok = (labels.shape == VOLUME and labels.dtype == torch.int64
              and int(labels.min()) >= 0 and int(labels.max()) < classes
              and bool(torch.isfinite(probs).all())
              and abs(float(probs[::16, ::16, ::16].sum(-1).mean()) - 1.0) < 1e-3)
        if not ok:
            raise SystemExit("the main path's labels or probabilities are malformed")
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"[serve] volume {VOLUME}x2, {chunks} chunks of {sw_batch} tiles: per-volume ms "
        f"{[round(t, 1) for t in times]}, mean {mean:.1f} ms, {60e3 / mean:.2f} volumes/min, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve] kernels {json.dumps(launches)} expected {json.dumps(expect)}")
    if launches != expect:
        raise SystemExit("the main path's kernel launches differ from the count the code predicts")

    if profile:
        profile_device_time(lambda: serve(volumes[1]), "one volume")

        # the same volume through the plain versions, for the dispatch a
        # later change may set from these numbers
        set_use_kernels(model, False)
        serve(volumes[1])
        t0 = time.perf_counter()
        serve(volumes[1])
        log(f"[profile] one volume through the plain versions: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        set_use_kernels(model, True)
    return launches, mean


def phase_conv() -> dict:
    """Kernel C's own path: the conv script's two stages (f32 check, bf16
    checks and times at the two decoder shapes), with each route's launches
    held to the count the plan predicts."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, plan
    from scripts import proto_conv_kernel_torch as conv_script

    # 1 f32 launch; per bf16 shape 1 checked launch, 1 warm-up and the timed ones
    shape, cout = conv_script.SHAPE_F32
    expect = dict.fromkeys(conv3x3x3.launches, 0)
    expect[plan(*shape, cout, torch.float32)["route"]] += 1
    for cin, cout in conv_script.SHAPES_BF16:
        route = plan(conv_script.BATCH, 96, 96, 96, cin, cout, torch.bfloat16)["route"]
        expect[route] += 2 + conv_script.REPS
    reset_launches(conv3x3x3)
    if conv_script.main([]) != 0:
        raise SystemExit("the conv script failed")
    launches = dict(conv3x3x3.launches)
    log(f"[conv] kernels {json.dumps({'conv3x3x3': launches})} expected {json.dumps(expect)}")
    if launches != expect:
        raise SystemExit("the conv script's kernel launches differ from the count the code predicts")
    return {"conv3x3x3": launches}


def training_patches(n: int, seed: int, cfg: dict = FLAGSHIP):
    """``n`` synthetic CT+PET patches of the ``img_size`` of ``cfg`` with
    8-class labels from a numpy seed, standardised per channel (the trainer
    phases bypass the loader and its transform graph)."""
    from multimodal_organ_segmentation_tpu_torch.data.synthetic import synthetic_volume

    rng = np.random.default_rng(seed)
    size = tuple(cfg["model"]["backbone"]["img_size"])
    batches = []
    for _ in range(n):
        image, label = synthetic_volume(size, cfg["model"]["out_channels"], rng)
        image = (image - image.mean(axis=(0, 1, 2))) / image.std(axis=(0, 1, 2))
        batches.append((image.astype(np.float32), label))
    return batches


def phase_train(profile: bool) -> dict:
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import to_host
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer, make_train_step

    cfg = train_config()
    micro = cfg["training"]["batch_size"]
    accum = cfg["training"]["accumulation_steps"]
    patches = training_patches(micro * accum, cfg["experiment"]["seed"])
    loader = [{"image": np.stack([p[0] for p in patches[i:i + micro]]),
               "label": np.stack([p[1] for p in patches[i:i + micro]])}
              for i in range(0, len(patches), micro)]

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, train_loader=loader)  # no device named: the card
    trainer.init_state()
    model = trainer.model
    if not (model.training and model.use_remat and model.dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in model.parameters())):
        raise SystemExit("the trainer's model is not bf16 compute on f32 master weights with remat")

    blocks = sum(cfg["model"]["backbone"]["depths"])
    steps = 1 + TRAIN_STEPS
    # remat runs each Swin block's forward twice; the fusions lie outside it
    expect = predicted_launches(micro, 2 * accum * steps, accum * steps)
    if any(counts["f32"] for counts in expect.values()):
        raise SystemExit(f"a flagship bf16 attention is planned off the tensor-core route: {expect}")

    reset_launches(window_mha, flash_attention)
    lr = trainer.scheduler.lr_for_epoch(0)
    t0 = time.perf_counter()
    trainer._train_epoch(lr)  # one optimiser step through the epoch loop
    torch.cuda.synchronize()
    log(f"[train] warm-up step through the epoch loop {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"loss {trainer.last_step_losses[0]:.4f}")
    losses, norms, times = list(trainer.last_step_losses), [], []
    step = trainer.train_step_fn()
    images, labels = trainer._stack_accum(loader)

    def one_step():
        state, metrics = step(trainer.state, images, labels, trainer.keys.next())
        torch.cuda.synchronize()
        return metrics

    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = one_step()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if float(metrics["skipped"]) != 0.0:
            raise SystemExit("a train step on finite data was skipped")
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"[train] micro-batch {micro} x accumulation {accum} of 96^3 patches: per-step ms "
        f"{[round(t, 1) for t in times]}, mean {mean:.1f} ms/step, "
        f"{micro * accum * 1e3 / mean:.2f} patches/s, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[train] losses on the same batch {[round(l, 4) for l in losses]}, grad_norm "
        f"{[round(g, 4) for g in norms]}, step {trainer.state.step}")
    log(f"[train] kernels {json.dumps(launches)} expected {json.dumps(expect)}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise SystemExit("a train step gave a non-finite loss or grad_norm")
    if not losses[-1] < losses[0]:
        raise SystemExit("the loss on the same batch did not fall over the steps")
    if launches != expect:
        raise SystemExit("the train path's kernel launches differ from the count the code predicts")

    if profile:
        profile_device_time(one_step, "one train step")

    # gradients reach every attention parameter through the kernels
    model.zero_grad(set_to_none=True)
    trainer.loss_fn(model(images[0]), labels[0]).backward()
    checked = 0
    for name, p in model.named_parameters():
        if any(key in name for key in ("rel_pos_bias", "attn.qkv", "q_proj", "k_proj", "v_proj",
                                       "out_proj")):
            checked += 1
            if p.grad is None or not bool(torch.isfinite(p.grad).all()) or float(p.grad.abs().max()) == 0:
                raise SystemExit(f"no gradient reaches {name}")
    model.zero_grad(set_to_none=True)
    log(f"[train] non-zero finite gradients on all {checked} attention parameters "
        "(rel_pos_bias, qkv, fusion projections)")

    # a non-finite batch is skipped: params, moments and EMA keep every bit
    trainer.state.ema_params = trainer._fresh_ema()
    guarded = make_train_step(model, trainer.state.optimizer, trainer.loss_fn, accum,
                              skip_nonfinite=True, ema_decay=EMA_DECAY)
    guarded(trainer.state, images, labels)
    moved = max(float((trainer.state.ema_params[n] - p.detach()).abs().max())
                for n, p in model.named_parameters())
    before = to_host({"tree": trainer.state.tree()})
    bad = images.clone()
    bad[1, 0, 5, 5, 5, 0] = float("nan")
    _, metrics = guarded(trainer.state, bad, labels)
    after = to_host({"tree": trainer.state.tree()})
    same = float(metrics["skipped"]) == 1.0 and moved > 0
    for key in ("params", "ema_params"):
        same = same and all(torch.equal(after["tree"][key][n], t)
                            for n, t in before["tree"][key].items())
    for idx, slot in before["tree"]["opt_state"]["state"].items():
        same = same and all(torch.equal(torch.as_tensor(after["tree"]["opt_state"]["state"][idx][k]),
                                        torch.as_tensor(v)) for k, v in slot.items())
    log(f"[train] non-finite batch: skipped {float(metrics['skipped'])}, params, moments and EMA "
        f"bit-identical: {same}")
    if not same:
        raise SystemExit("a skipped step changed the params, the moments or the EMA")
    del trainer, model, guarded, step, before, after
    torch.cuda.empty_cache()

    # one f32 step on one micro-batch: through the kernels, then the plain versions
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for use_kernels in (True, False):
        t32 = Trainer(train_config("fp32", accumulation_steps=1))
        t32.init_state()
        set_use_kernels(t32.model, use_kernels)
        reset_launches(window_mha)
        _, metrics = t32.train_step_fn()(t32.state, images[:1].float(), labels[:1], t32.keys.next())
        results[use_kernels] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        if window_mha.launches != {"mma": 0, "f32": 2 * blocks if use_kernels else 0}:
            raise SystemExit(f"the f32 step with use_kernels={use_kernels} launched kernel A "
                             f"{window_mha.launches} times")
        del t32
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (lk, gk), (lp, gp) = results[True], results[False]
    rel = max(abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp))
    log(f"[train] f32 step, one micro-batch: kernels loss {lk:.6f} grad_norm {gk:.6f}, plain "
        f"loss {lp:.6f} grad_norm {gp:.6f}, max relative difference {rel:.2e} (tol {STEP_RTOL:.0e})")
    if not rel <= STEP_RTOL:
        raise SystemExit("the f32 train step through the kernels disagrees with the plain versions")
    return launches


def _log_lines(path: Path, start: int) -> list:
    """The lines a CLI run appended to its log file past ``start``."""
    return path.read_text().splitlines()[start:] if path.exists() else []


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _cli(argv, device: str) -> float:
    """One in-process run of the port's CLI; its wall seconds."""
    from multimodal_organ_segmentation_tpu_torch import cli

    t0 = time.perf_counter()
    cli.main([*argv, "--device", device])
    _sync(device)
    return time.perf_counter() - t0


def phase_cli(serve_ms: float, device: str = "cuda") -> tuple:
    """``--mode train``, ``inference`` and ``eval`` through ``cli.main`` on
    the flagship YAML (full width and depth, augmentation on, ``--device
    cuda``). Returns kernel A's and B's launches over the inference runs,
    and a directory holding the 192×192×256 case's mask for [analysis].
    (``device="cpu"`` rehearses the phase's control flow on the CPU.)"""
    import torch

    from multimodal_organ_segmentation_tpu_torch.data.dataset import get_dataset
    from multimodal_organ_segmentation_tpu_torch.data.synthetic import generate_synthetic_dataset
    from multimodal_organ_segmentation_tpu_torch.data.transforms import get_transforms
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        SlidingWindowRunner,
        predict_labels,
        sliding_window_inference,
    )
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import load_checkpoint
    from multimodal_organ_segmentation_tpu_torch.train.metrics import (
        AverageSurfaceDistance,
        DiceMetric,
        HausdorffDistance,
        SurfaceDice,
    )
    from multimodal_organ_segmentation_tpu_torch.utils.config import load_config
    from multimodal_organ_segmentation_tpu_torch.utils import nifti
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

    config = load_config(FLAGSHIP_YAML)
    seed = config.get("experiment.seed")
    Path("outputs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_", dir="outputs")).resolve()
    t0 = time.perf_counter()
    n_train, n_val, n_test = CLI_SPLITS
    generate_synthetic_dataset(work / "data", n_train=n_train, n_val=n_val, n_test=n_test,
                               shape=CLI_CASE, num_classes=config.get("model.out_channels"),
                               seed=seed)
    rng = np.random.default_rng(seed)
    affine = np.diag([0.9, 0.9, 1.5, 1.0])
    for case, shape in CLI_VOLUMES.items():
        for mod in config.get("data.modalities"):
            save_nifti(rng.standard_normal(shape, np.float32), work / "input" / mod.lower() /
                       f"{case}.nii.gz", affine=affine)
    log(f"[cli] inputs under {work}: {n_train}/{n_val}/{n_test} synthetic {CLI_CASE} cases and "
        f"{len(CLI_VOLUMES)} inference cases written in {time.perf_counter() - t0:.1f} s")
    logs = work / "logs" / config.get("experiment.name")
    out = work / "out" / config.get("experiment.name")
    common = ["--config", FLAGSHIP_YAML,
              "--set", f"data.data_root={work / 'data'}",
              "--set", f"experiment.output_dir={work / 'out'}",
              "--set", f"experiment.log_dir={work / 'logs'}"]
    config.set("data.data_root", str(work / "data"))
    if not config.get("data.augmentation.enabled"):
        raise SystemExit("the flagship YAML no longer trains with augmentation on")

    # -- train: one epoch = one optimiser step, augmentation on the card
    wall = _cli(["--mode", "train", "--epochs", "1", "--set", "training.native_val_every=1",
                 *common], device)
    record = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
    steps = [line for line in _log_lines(logs / "train.log", 0)
             if "| DEBUG | step " in line]
    ok = (math.isfinite(record["train_loss"]) and (out / "last" / "tree.pt").exists()
          and record.get("val_dice_native") is not None and len(steps) == 1)
    log(f"[cli] train: 1 epoch in {wall * 1e3:.1f} ms of wall time ({record['seconds']} s in "
        f"the epoch loop: the step, resized-grid and native-grid validation); "
        f"{steps[0].split('| DEBUG | ')[-1] if steps else 'no step logged'}; train_loss "
        f"{record['train_loss']}, val_dice {record['val_dice']}, val_dice_native "
        f"{record.get('val_dice_native')}, last checkpoint {(out / 'last').exists()}")
    if not ok:
        raise SystemExit("the CLI train run gave no finite loss, no last checkpoint, no step or "
                         "no native-grid validation")

    # the transform graph alone, on the card: the train split's 8 samples.
    # First their host-to-device copies alone, twice (the second pass reuses
    # the first's pinned blocks), and the host transposition to C order that
    # the copy leaves to the card (NIfTI arrays lie in Fortran order)
    dataset = get_dataset(config, split="train")
    raw = [dataset.load_raw(i) for i in range(len(dataset))]
    pipe = get_transforms(config, mode="train", device=device)
    copy_ms = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        moved = [{k: pipe._to_device(s[k]) for k in ("image", "label")} for s in raw]
        _sync(device)
        copy_ms.append((time.perf_counter() - t0) * 1e3 / len(raw))
    t0 = time.perf_counter()
    for s in raw:
        np.ascontiguousarray(s["image"]), np.ascontiguousarray(s["label"])
    transpose_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    layout = "".join("C" if raw[0][k].flags["C_CONTIGUOUS"] else
                     "F" if raw[0][k].flags["F_CONTIGUOUS"] else "-" for k in ("image", "label"))
    pipe(raw[0], key=pipe.key_for(1, 0))
    _sync(device)
    t0 = time.perf_counter()
    for i, sample in enumerate(raw):
        outs = pipe(sample, key=pipe.key_for(1, i))
    _sync(device)
    transform_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    # then the graph on samples already on the card
    t0 = time.perf_counter()
    for i, sample in enumerate(moved):
        pipe(sample, key=pipe.key_for(1, i))
    _sync(device)
    graph_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    log(f"[cli] transform graph (normalise, flip, rot90, intensity, noise, resize to 96^3) on the "
        f"card: {transform_ms:.2f} ms per {CLI_CASE}x2 sample, host-to-device copy included "
        f"(apart: copy {copy_ms[0]:.2f} ms first pass, {copy_ms[1]:.2f} ms second; graph on "
        f"resident samples {graph_ms:.2f} ms; host transposition to C order, not done, "
        f"{transpose_ms:.2f} ms, image/label layout {layout}); "
        f"out {tuple(outs['image'].shape)} {outs['image'].dtype} on {outs['image'].device}")
    del raw, outs, moved

    # -- inference: plain, then with the uncertainty map
    sw = config.get("inference.batch_size")
    roi = tuple(config.get("inference.sliding_window.roi_size"))
    overlap = config.get("inference.sliding_window.overlap")
    mode = config.get("inference.sliding_window.mode")
    classes = config.get("model.out_channels")
    grid = SlidingWindowRunner(None, roi, classes, overlap, sw)
    chunks = sum(grid.grid(shape)[0].shape[0] for shape in CLI_VOLUMES.values())
    expect = predicted_launches(sw, 2 * chunks, 2 * chunks)
    ckpt = str(out / "last")
    reset_launches(window_mha, flash_attention)
    start = len(_log_lines(logs / "inference.log", 0))
    walls = [_cli(["--mode", "inference", "--checkpoint", ckpt, "--input", str(work / "input"),
                   "--output", str(work / "pred"), *common], device)]
    walls.append(_cli(["--mode", "inference", "--checkpoint", ckpt, "--input",
                       str(work / "input"), "--output", str(work / "pred_unc"),
                       "--set", "inference.save_uncertainty=true", *common], device))
    launches = attention_launches()
    lines = _log_lines(logs / "inference.log", start)
    per_case = [ln.split("| INFO | ")[-1] for ln in lines if re.search(r"\| case \S+ \(", ln)]
    totals = [ln.split("| INFO | ")[-1] for ln in lines if "| Predicted " in ln]
    log(f"[cli] inference: 2 runs of {len(CLI_VOLUMES)} cases in "
        f"{[round(w * 1e3, 1) for w in walls]} ms of wall time (model build and checkpoint "
        f"load included); {'; '.join(totals)}")
    for line in per_case:
        log(f"[cli]   {line}")
    log(f"[cli] inference kernels {json.dumps(launches)} expected {json.dumps(expect)} "
        f"({chunks} chunks of {sw} tiles a run); [serve] per-volume ms {serve_ms:.1f}")
    if launches != expect:
        raise SystemExit("the CLI inference's kernel launches differ from the runner's grid")

    # the library path on the same weights and volumes
    tree = load_checkpoint(ckpt, map_location=device)["tree"]
    model = build_model(config, device=device)
    model.load_state_dict(tree["params"])
    del tree
    for case, shape in CLI_VOLUMES.items():
        mods = [load_nifti(work / "input" / m.lower() / f"{case}.nii.gz", return_affine=True)
                for m in config.get("data.modalities")]
        in_affine = mods[0][1]
        vol = torch.from_numpy(np.stack([m[0] for m in mods], axis=-1)).to(device)
        ref = library_mask(model, vol, config)
        for run in ("pred", "pred_unc"):
            img = nifti.load(str(work / run / f"{case}_pred.nii.gz"))
            mask, kept = img.dataobj, np.array_equal(img.affine, in_affine)
            same = mask.dtype == np.uint8 and mask.shape == shape and kept and np.array_equal(
                mask, ref)
            log(f"[cli] {run}/{case}_pred.nii.gz: {mask.dtype} {mask.shape}, voxels differing "
                f"from the library path {int((mask != ref).sum()) if mask.shape == shape else 'n/a'}"
                f", affine kept {kept}: {'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"the CLI mask of {case} is not the library path's")
        unc = load_nifti(work / "pred_unc" / f"{case}_unc.nii.gz")
        log(f"[cli] pred_unc/{case}_unc.nii.gz: {unc.shape}, range [{unc.min():.4f}, "
            f"{unc.max():.4f}]")
        if unc.shape != shape or unc.min() < 0 or unc.max() > 1 + 1e-6:
            raise SystemExit(f"the uncertainty map of {case} is not in [0, 1]")
        del vol

    # -- eval on native grids
    wall = _cli(["--mode", "eval", "--checkpoint", ckpt, "--set", "evaluation.sliding_window=true",
                 *common], device)
    metrics = json.loads((out / "eval_native.json").read_text())
    with open(out / "eval_native_cases.csv") as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    n_cls = classes
    cols = (["case", "dice"] + [f"dice_c{c}" for c in range(n_cls)] + ["hd95", "surface_dice"]
            + [f"surface_dice_c{c}" for c in range(n_cls)] + ["assd"]
            + [f"assd_c{c}" for c in range(n_cls)])
    missing = [k for k in EVAL_KEYS if k not in metrics]
    if missing or header != cols or len(rows) != n_test or metrics["num_cases"] != n_test:
        raise SystemExit(f"eval_native.json or its CSV lacks the JAX CLI's keys: {missing}, "
                         f"{header}")
    # the library path's masks of the test cases: the same per-case Dice, and
    # the surface metrics' host time (EDT included)
    test = get_dataset(config, split="test",
                       transform=get_transforms(config, mode="native", device=device))
    surface_ms = []
    for i, row in enumerate(metrics["per_case"]):
        sample = test[i]
        with torch.no_grad():
            pred = predict_labels(lambda v: sliding_window_inference(v, model, roi, classes,
                                                                     overlap, sw, mode),
                                  sample["image"])
        pred = postprocess_from_config(pred.cpu().numpy(), config)
        label = sample["label"].cpu().numpy()
        dm = DiceMetric(classes)
        dm.update(pred[None], label[None])
        spacing = tuple(np.sqrt((np.asarray(sample["affine"])[:3, :3] ** 2).sum(axis=0)).tolist())
        t0 = time.perf_counter()
        HausdorffDistance(95).update(pred[None], label[None], spacing=spacing)
        cache = {}
        SurfaceDice(classes).update(pred[None], label[None], spacing=spacing, distance_cache=cache)
        AverageSurfaceDistance(classes).update(pred[None], label[None], spacing=spacing,
                                               distance_cache=cache)
        surface_ms.append((time.perf_counter() - t0) * 1e3)
        lib_dice = [v if u > 0 else None for v, u in
                    zip(dm.compute()["dice_per_class"], dm.union)]
        if row["case"] != sample["patient_id"] or row["dice_per_class"] != lib_dice:
            raise SystemExit(f"eval's per-case Dice of {row['case']} is not the library path's: "
                             f"{row['dice_per_class']} vs {lib_dice}")
    log(f"[cli] eval: {n_test} native {CLI_CASE} cases in {wall * 1e3:.1f} ms of wall time; "
        f"dice {metrics['dice']:.4f} hd95 {metrics['hd95']} surface_dice "
        f"{metrics['surface_dice']} assd {metrics['assd']}; eval_native.json has every key and "
        f"the CSV every column of the JAX CLI; per-case Dice equal to the library path's; "
        f"surface metrics (HD95 + NSD + ASSD, EDT included) host ms per case "
        f"{[round(t, 1) for t in surface_ms]}")
    del model
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_", dir="outputs")).resolve() / "case"
    keep.mkdir()
    shutil.copy(work / "pred" / "flagship_pred.nii.gz", keep)
    shutil.rmtree(work)
    return launches, keep


def add_counts(*runs) -> dict:
    """The sum, route by route, of kernel launch counts
    ``{wrapper: {route: n}}``."""
    total: dict = {}
    for run in runs:
        for name, counts in run.items():
            into = total.setdefault(name, {})
            for route, n in counts.items():
                into[route] = into.get(route, 0) + n
    return total


def attention_launches() -> dict:
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

    return {"window_attention": dict(window_mha.launches),
            "flash_attention": dict(flash_attention.launches)}


def serving_config(work: Path) -> dict:
    """The flagship's dict as the service reads it, its outputs under ``work``
    (``scan_blocks`` off: the same unrolled blocks, and what ``--format
    torch`` and ``monai_compat`` need)."""
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["model"]["backbone"]["scan_blocks"] = False
    cfg["experiment"].update(output_dir=str(work / "out"), log_dir=str(work / "logs"))
    return cfg


def _http(base: str, path: str, body=None):
    """GET (no body) or POST a JSON body; (status, parsed reply)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def library_mask(model, vol, config):
    """The library path's mask of ``vol`` under ``config`` (a ``ConfigNode``):
    ``sliding_window_inference`` + ``predict_labels`` + postprocess on
    ``model``."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        predict_labels,
        sliding_window_inference,
    )

    sw = config.get("inference.sliding_window")
    with torch.no_grad():
        ref = predict_labels(lambda v: sliding_window_inference(
            v, model, tuple(sw["roi_size"]), config.get("model.out_channels"), sw["overlap"],
            config.get("inference.batch_size"), sw["mode"]), vol)
    return postprocess_from_config(ref.cpu().numpy().astype(np.uint8), config)


def serve_subprocess(cfg_path: Path, ckpt: Path, inputs: dict, device: str) -> None:
    """``python -m multimodal_organ_segmentation_tpu_torch --mode serve`` in a
    process of its own (on the card unless ``device`` is the CPU): one
    request, then SIGTERM; it must drain and exit 0."""
    import signal
    import threading

    argv = [sys.executable, "-m", "multimodal_organ_segmentation_tpu_torch", "--mode", "serve",
            "--config", str(cfg_path), "--checkpoint", str(ckpt), "--port", "0"]
    if device == "cpu":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port = [], {}

    def watch():
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"http://[\d.]+:(\d+)", line)
            if m and "port" not in port:
                port["port"] = int(m.group(1))

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        while "port" not in port and proc.poll() is None and time.perf_counter() - t0 < 300:
            time.sleep(0.1)
        if "port" not in port:
            raise SystemExit("the serve process did not come up:\n" + "".join(lines)[-3000:])
        up = time.perf_counter() - t0
        code, res = _http(f"http://127.0.0.1:{port['port']}", "/v1/segment",
                          {"inputs": inputs, "case_id": "sub"})
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        watcher.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    log_text = "".join(lines)
    final = [ln for ln in lines if "final stats: " in ln]
    log(f"[http] --mode serve process: up in {up:.1f} s, one request {code} in "
        f"{res.get('total_s')} s (device_s {res.get('device_s')}), SIGTERM → exit {rc}; "
        f"{final[0].split('| INFO | ')[-1].strip() if final else 'no final stats'}")
    if code != 200 or rc != 0 or "SIGTERM: draining" not in log_text or not final:
        raise SystemExit("the serve process did not answer, drain and exit 0 on SIGTERM:\n"
                         + log_text[-3000:])


def phase_http(device: str = "cuda", volume=VOLUME) -> tuple:
    """The HTTP service on the flagship at full width: a port checkpoint of
    a seeded init, ``make_server`` on an OS-assigned port in a thread,
    ``/v1/warmup`` at ``volume``, three ``/v1/segment`` requests on one
    synthetic CT+PET case (two of them concurrent), one with the uncertainty
    map, ``/v1/stats``; every mask equal to the library path's voxel for
    voxel and kernel A's and B's launches to the plan. Then ``--mode serve``
    in a process of its own. Returns (launches, the checkpoint, the case,
    the config, the served mask, the work directory)."""
    import threading

    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import SlidingWindowRunner
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.serving.server import InferenceService, make_server
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

    Path("outputs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_http_", dir="outputs")).resolve()
    cfg = serving_config(work)
    cfg_path = work / "flagship.yaml"
    cfg_path.write_text(json.dumps(cfg))  # JSON is YAML
    seed = cfg["experiment"]["seed"]
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, train=True)  # f32 weights, as training writes them
    save_checkpoint({"step": 0, "params": model.state_dict(), "opt_state": None,
                     "ema_params": None}, work / "ckpt")
    del model
    rng = np.random.default_rng(seed)
    inputs = {}
    for mod in cfg["data"]["modalities"]:
        inputs[mod] = str(work / "input" / mod.lower() / "case.nii.gz")
        save_nifti(rng.standard_normal(volume, np.float32), inputs[mod],
                   affine=np.diag([0.9, 0.9, 1.5, 1.0]))
    log(f"[http] checkpoint and one {volume}x2 case written in {time.perf_counter() - t0:.1f} s")

    service = InferenceService(ConfigNode(cfg), work / "ckpt", device=device)
    httpd = make_server(service, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        code, info = _http(base, "/v1/warmup", {"shape": list(volume)})
        log(f"[http] /v1/warmup {list(volume)}: {code} {info}")
        if code != 200:
            raise SystemExit("the warm-up request failed")
        reset_launches(window_mha, flash_attention)
        replies = {}

        def segment(case_id, **extra):
            replies[case_id] = _http(base, "/v1/segment", {"inputs": inputs, "case_id": case_id,
                                                           "output_dir": str(work / "served"),
                                                           **extra})

        segment("r1")
        both = [threading.Thread(target=segment, args=(c,)) for c in ("r2", "r3")]
        for t in both:
            t.start()
        for t in both:
            t.join()
        segment("r4", uncertainty=True)
        launches = attention_launches()
        code, stats = _http(base, "/v1/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    for case_id, (code, res) in replies.items():
        log(f"[http] /v1/segment {case_id}: {code} load_s {res.get('load_s')} device_s "
            f"{res.get('device_s')} total_s {res.get('total_s')}"
            + (" (with the uncertainty map)" if case_id == "r4" else "")
            + (" (concurrent)" if case_id in ("r2", "r3") else ""))
        if code != 200:
            raise SystemExit(f"the request {case_id} failed: {res}")
    log(f"[http] /v1/stats: requests {stats['requests']}, rejected {stats['rejected']}, p50 "
        f"load_s {stats['load_s']['p50']} device_s {stats['device_s']['p50']} total_s "
        f"{stats['total_s']['p50']}, p95 total_s {stats['total_s']['p95']}")
    if stats["requests"] != 4 or stats["server_errors"] or stats["client_errors"]:
        raise SystemExit(f"the service's counters are wrong: {stats}")

    sw = cfg["inference"]["batch_size"]
    sw_cfg = cfg["inference"]["sliding_window"]
    chunks = SlidingWindowRunner(None, tuple(sw_cfg["roi_size"]), cfg["model"]["out_channels"],
                                 sw_cfg["overlap"], sw).grid(tuple(volume))[0].shape[0]
    expect = predicted_launches(sw, 4 * chunks, 4 * chunks)
    log(f"[http] kernels {json.dumps(launches)} expected {json.dumps(expect)} (4 requests of "
        f"{chunks} chunks of {sw} tiles)")
    if device == "cuda" and launches != expect:
        raise SystemExit("the served requests' kernel launches differ from the plan")

    vol = torch.from_numpy(np.stack([load_nifti(inputs[m]) for m in cfg["data"]["modalities"]],
                                    axis=-1)).to(device)
    ref = library_mask(service.runner.predict_fn.__self__.model, vol, ConfigNode(cfg))
    for case_id in replies:
        mask = load_nifti(work / "served" / f"{case_id}_pred.nii.gz").astype(np.uint8)
        diff = int((mask != ref).sum()) if mask.shape == ref.shape else -1
        log(f"[http] served/{case_id}_pred.nii.gz: voxels differing from the library path {diff}")
        if diff:
            raise SystemExit(f"the served mask of {case_id} is not the library path's")
    unc = load_nifti(work / "served" / "r4_unc.nii.gz")
    if unc.shape != tuple(volume) or unc.min() < 0 or unc.max() > 1 + 1e-6:
        raise SystemExit("the served uncertainty map is not in [0, 1]")
    del service, vol
    if device == "cuda":
        torch.cuda.empty_cache()
    serve_subprocess(cfg_path, work / "ckpt", inputs, device)
    return launches, cfg, cfg_path, inputs, ref, work


def phase_tune(cfg_path: Path, work: Path, device: str = "cuda", volume=VOLUME,
               sw_batches=(8, 15)) -> dict:
    """``--mode tune`` through ``cli.main`` on the flagship at ``volume``
    over chunk sizes ``sw_batches`` and overlaps 0.5 and 0.25, one timed run
    each; every candidate's volumes/min, the written profile, and kernel A's
    and B's launches to the plan."""
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import SlidingWindowRunner
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

    cfg = json.loads(cfg_path.read_text())
    overlaps, repeats = (0.5, 0.25), 1
    sw_cfg = cfg["inference"]["sliding_window"]
    expect = {}
    for ov in overlaps:
        for sw in sw_batches:
            chunks = SlidingWindowRunner(None, tuple(sw_cfg["roi_size"]),
                                         cfg["model"]["out_channels"], ov, sw
                                         ).grid(tuple(volume))[0].shape[0]
            passes = (1 + repeats) * chunks  # the warm-up run and the timed ones
            expect = add_counts(expect, predicted_launches(sw, passes, passes))
    reset_launches(window_mha, flash_attention)
    profile = work / "tuned_serving.yaml"
    wall = _cli(["--mode", "tune", "--config", str(cfg_path), "--output", str(profile),
                 "--set", f"tune.volume_shape={list(volume)}",
                 "--set", f"tune.sw_batches={list(sw_batches)}",
                 "--set", f"tune.overlaps={list(overlaps)}", "--set", f"tune.repeats={repeats}"],
                device)
    launches = attention_launches()
    report = json.loads(profile.with_suffix(".yaml.report.json").read_text())
    for r in report:
        log(f"[tune] overlap {r['overlap']} sw_batch {r['sw_batch']}: "
            + (f"{r['vol_per_min']} volumes/min, {r['seconds_per_volume']} s a volume (first run "
               f"{r['compile_s']} s)" if "vol_per_min" in r else f"FAILED {r['error']}"))
    log(f"[tune] {len(report)} candidates in {wall:.1f} s of wall time; profile: "
        + " | ".join(ln for ln in profile.read_text().splitlines()))
    log(f"[tune] kernels {json.dumps(launches)} expected {json.dumps(expect)}")
    if len(report) != len(overlaps) * len(sw_batches) or any("error" in r for r in report):
        raise SystemExit("a tuning candidate failed")
    if device == "cuda" and launches != expect:
        raise SystemExit("the tuner's kernel launches differ from the plan")
    return launches


def phase_export(cfg: dict, cfg_path: Path, inputs: dict, served_mask, work: Path,
                 device: str = "cuda", monai_fs: int = 48) -> dict:
    """``--mode export --format pt2`` of the [http] checkpoint; the program
    loaded in this process and served by ``InferenceService``: the mask
    equal to the checkpoint-served one, kernels A and B launched through
    the program as planned. Then ``--format torch`` of a ``monai_compat``
    SwinUNETR (fs ``monai_fs``, depths 2-2-2-2) and ``--pretrained`` of that
    ``.pth`` into the ``Trainer``: the weights carried exactly, and one 96³
    tile through kernel A against the plain path, f32 and bf16."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.program_export import load_program
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import SlidingWindowRunner
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.serving.server import InferenceService
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti

    program = work / "flagship.pt2"
    wall = _cli(["--mode", "export", "--format", "pt2", "--config", str(cfg_path),
                 "--checkpoint", str(work / "ckpt"), "--output", str(program)], device)
    t0 = time.perf_counter()
    call, meta = load_program(program)
    load_s = time.perf_counter() - t0
    targets = [str(n.target) for n in call.graph.nodes if n.op == "call_function"]
    nodes = {op: targets.count(f"organseg_torch.{op}.default")
             for op in ("window_mha", "flash_attention")}
    log(f"[export] --format pt2: {program.stat().st_size / 2**20:.1f} MiB in {wall:.1f} s, loaded "
        f"in {load_s:.1f} s; input {meta['input']['shape']}, platforms {meta['platforms']}; "
        f"custom-op nodes {nodes}")
    del call
    sw = cfg["inference"]["batch_size"]
    sw_cfg = cfg["inference"]["sliding_window"]
    chunks = SlidingWindowRunner(None, tuple(sw_cfg["roi_size"]), cfg["model"]["out_channels"],
                                 sw_cfg["overlap"], sw).grid(served_mask.shape)[0].shape[0]
    expect = predicted_launches(sw, chunks, chunks)
    service = InferenceService(ConfigNode(cfg), program, device=device)
    reset_launches(window_mha, flash_attention)
    res = service.segment(inputs, output_dir=str(work / "artifact"), case_id="a")
    artifact = attention_launches()
    mask = load_nifti(work / "artifact" / "a_pred.nii.gz").astype(np.uint8)
    diff = int((mask != served_mask).sum())
    log(f"[export] served from the program ({service.model_name}): load_s {res['load_s']} device_s "
        f"{res['device_s']} total_s {res['total_s']}; voxels differing from the checkpoint-served "
        f"mask {diff}; kernels {json.dumps(artifact)} expected {json.dumps(expect)}")
    if diff or nodes != {"window_mha": sum(FLAGSHIP["model"]["backbone"]["depths"]),
                         "flash_attention": len(FLAGSHIP["model"]["fusion"]["stages"])}:
        raise SystemExit("the exported program's mask or graph is not the model's")
    if device == "cuda" and artifact != expect:
        raise SystemExit("the exported program did not launch kernels A and B as planned")
    del service
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference .pth round trip of a MONAI-compatible SwinUNETR
    mcfg = json.loads(json.dumps(cfg))
    mcfg["model"]["backbone"].update(monai_compat=True, feature_size=monai_fs)
    mcfg["model"]["fusion"] = {"type": "early"}
    mcfg_path = work / "monai.yaml"
    mcfg_path.write_text(json.dumps(mcfg))
    torch.manual_seed(7)
    model = build_model(mcfg, device=device, train=True)
    with torch.no_grad():  # tables away from their zero init, so the bias shows
        for name, p in model.named_parameters():
            if name.endswith("rel_pos_bias"):
                p.normal_(0.0, 0.5)
    save_checkpoint({"step": 0, "params": model.state_dict(), "opt_state": None,
                     "ema_params": None}, work / "monai_ckpt")
    pth = work / "monai.pth"
    wall = _cli(["--mode", "export", "--format", "torch", "--config", str(mcfg_path),
                 "--checkpoint", str(work / "monai_ckpt"), "--output", str(pth)], device)
    mcfg["model"]["pretrained"] = str(pth)
    trainer = Trainer(mcfg, device=device)
    trainer.init_state()
    carried = all(torch.equal(trainer.model.state_dict()[k], v)
                  for k, v in model.state_dict().items())
    log(f"[export] --format torch of a monai_compat SwinUNETR (fs {monai_fs}): "
        f"{pth.stat().st_size / 2**20:.1f} MiB in {wall:.1f} s; --pretrained through the Trainer "
        f"carries every weight exactly: {carried}")
    if not carried:
        raise SystemExit("the reference .pth did not carry the weights")
    del model
    state = trainer.model.state_dict()
    del trainer
    roi = tuple(mcfg["model"]["backbone"]["img_size"])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, *roi, 2), np.float32)
                         ).to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    reset_launches(window_mha, flash_attention)
    for precision, tol in (("fp32", MODEL_TOL), ("bf16", MODEL_TOL_BF16)):
        pcfg = json.loads(json.dumps(mcfg))
        pcfg["hardware"]["mixed_precision"] = precision
        pcfg["model"]["pretrained"] = None
        monai = build_model(pcfg, device=device)  # the serving model, in its compute dtype
        monai.load_state_dict(state)
        with torch.no_grad():
            kern = monai(x).float()
            set_use_kernels(monai, False)
            plain = monai(x).float()
        _sync(device)
        err = (kern - plain).abs().max().item()
        log(f"[export] monai_compat {precision}, one {'x'.join(map(str, roi))} tile: max |logit "
            f"kernels - plain| {err:.3e} (tol {tol:.0e}; largest |logit| "
            f"{plain.abs().max().item():.2f})")
        if not (torch.isfinite(kern).all() and err <= tol):
            raise SystemExit(f"the {precision} monai_compat model through the kernels disagrees "
                             "with the plain versions")
        del monai, kern, plain
    monai_launches = attention_launches()
    log(f"[export] monai_compat kernels {json.dumps(monai_launches)}")
    if device == "cuda" and not launch_count(monai_launches["window_attention"]):
        raise SystemExit("the monai_compat model did not launch kernel A")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del state, x
    return add_counts(artifact, monai_launches)


def planned_flash_launches(cfg: dict, tiles: int, repeat: int) -> dict:
    """Each route's launches of kernel B when every fusion of a batch of
    ``tiles`` tiles of the model of ``cfg`` runs ``repeat`` times, by the
    routes the wrapper's plan gives its shapes in the config's type; {} of
    zeros for a model without cross attention."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import compute_dtype
    from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as fa
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    counts = dict.fromkeys(fa.ROUTES, 0)
    if cfg["model"]["name"] == "dual_encoder":
        dtype = compute_dtype(ConfigNode(cfg))
        for _, b, n, heads, d in dual_encoder_flash_shapes(cfg, tiles):
            counts[fa.plan(b, n, n, heads, d, dtype)["route"]] += repeat
    if counts["f32"] and cfg["hardware"]["mixed_precision"] == "bf16":
        raise SystemExit(f"a bf16 fusion of {cfg['model']['name']} is planned off the tensor-core "
                         f"route: {counts}")
    return counts


def models_serve(key: str, cfg: dict, rng) -> dict:
    """``build_model`` of ``cfg`` (seeded weights), then sliding-window
    inference + ``predict_labels`` over a warm-up and a timed 192×192×256
    volume with one channel per modality; kernel B's launches per route held
    to the tile grid's plan. Returns them."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        predict_labels,
        sliding_window_inference,
        tile_count,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    sw_cfg = cfg["inference"]["sliding_window"]
    roi, overlap, mode = tuple(sw_cfg["roi_size"]), sw_cfg["overlap"], sw_cfg["mode"]
    sw_batch = cfg["inference"]["batch_size"]
    classes = cfg["model"]["out_channels"]
    tiles = tile_count(VOLUME, roi, overlap)
    chunks = math.ceil(tiles / sw_batch)
    expect = planned_flash_launches(cfg, sw_batch, 2 * chunks)
    channels = len(cfg["data"]["modalities"])
    volumes = [torch.from_numpy(rng.standard_normal((*VOLUME, channels), np.float32)).cuda()
               for _ in range(2)]

    def serve(vol):
        labels, probs = predict_labels(
            lambda v: sliding_window_inference(v, model, roi, classes, overlap, sw_batch, mode),
            vol, return_probs=True)
        torch.cuda.synchronize()
        return labels, probs

    reset_launches(flash_attention)
    t0 = time.perf_counter()
    serve(volumes[0])
    warm = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    labels, probs = serve(volumes[1])
    ms = (time.perf_counter() - t0) * 1e3
    ok = (labels.shape == VOLUME and int(labels.min()) >= 0 and int(labels.max()) < classes
          and bool(torch.isfinite(probs).all())
          and abs(float(probs[::16, ::16, ::16].sum(-1).mean()) - 1.0) < 1e-3)
    launches = dict(flash_attention.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[models] {key} ({cfg['model']['name']}, {cfg['hardware']['mixed_precision']}): volume "
        f"{VOLUME}x{channels}, {tiles} tiles in {chunks} chunks of {sw_batch} ({roi[0]}^3 ROI): "
        f"warm-up {warm:.1f} ms, per-volume ms {ms:.1f}, {60e3 / ms:.2f} volumes/min, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; flash_attention {json.dumps(launches)} "
        f"expected {json.dumps(expect)}")
    if not ok:
        raise SystemExit(f"{key}: the labels or probabilities are malformed")
    if launches != expect:
        raise SystemExit(f"{key}: kernel B's launches differ from the tile grid's plan")
    return launches


def models_train(rng) -> tuple:
    """The 128³ DualEncoder through the ``Trainer``'s epoch loop: one warm-up
    optimiser step, then timed steps, of micro-batch 1 × accumulation 8
    (its YAML's), bf16 on f32 master weights, AdamW, ``dice_ce``, head
    dropout 0.1. Returns (kernel B's launches, the trainer)."""
    import copy

    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer, _dropout_active
    from multimodal_organ_segmentation_tpu_torch.utils.prng import KeyStream

    cfg = model_config(DE128)
    micro = cfg["training"]["batch_size"]
    accum = cfg["training"]["accumulation_steps"]
    patches = training_patches(micro * accum, cfg["experiment"]["seed"], cfg)
    loader = [{"image": np.stack([p[0] for p in patches[i:i + micro]]),
               "label": np.stack([p[1] for p in patches[i:i + micro]])}
              for i in range(0, len(patches), micro)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, train_loader=loader)
    trainer.init_state()
    model = trainer.model
    if not (model.training and model.dtype == torch.bfloat16 and _dropout_active(model)
            and all(p.dtype == torch.float32 for p in model.parameters())):
        raise SystemExit("the DualEncoder trainer's model is not bf16 compute on f32 master "
                         "weights with its head dropout")
    steps = 1 + MODELS_TRAIN_STEPS
    expect = planned_flash_launches(cfg, micro, accum * steps)

    reset_launches(flash_attention)
    t0 = time.perf_counter()
    trainer._train_epoch(trainer.scheduler.lr_for_epoch(0))
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) * 1e3
    losses, norms, times = list(trainer.last_step_losses), [], []
    step = trainer.train_step_fn()
    images, labels = trainer._stack_accum(loader)
    for _ in range(MODELS_TRAIN_STEPS):
        t0 = time.perf_counter()
        _, metrics = step(trainer.state, images, labels, trainer.keys.next())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(flash_attention.launches)
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"[models] {DE128} train: micro-batch {micro} x accumulation {accum} of "
        f"{cfg['model']['backbone']['img_size'][0]}^3 patches: "
        f"warm-up step through the epoch loop {warm:.1f} ms, per-step ms "
        f"{[round(t, 1) for t in times]}, mean {mean:.1f} ms/step, "
        f"{micro * accum * 1e3 / mean:.2f} patches/s, max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"losses {[round(v, 4) for v in losses]}, grad_norm {[round(g, 4) for g in norms]}; "
        f"flash_attention {json.dumps(launches)} expected {json.dumps(expect)} "
        f"({sum(expect.values()) // steps} a step)")
    if not all(math.isfinite(v) for v in losses + norms):
        raise SystemExit("a DualEncoder train step gave a non-finite loss or grad_norm")
    if launches != expect:
        raise SystemExit("the DualEncoder train path's kernel B launches differ from the plan")

    # gradients reach every fusion parameter through kernel B
    model.zero_grad(set_to_none=True)
    trainer.loss_fn(model(images[0]), labels[0]).backward()
    fusion = [(n, p) for n, p in model.named_parameters() if n.startswith("fusion_")]
    for name, p in fusion:
        if p.grad is None or not bool(torch.isfinite(p.grad).all()) or float(p.grad.abs().max()) == 0:
            raise SystemExit(f"no gradient reaches {name}")
    model.zero_grad(set_to_none=True)

    # the channel-dropout draws follow the step's key: two steps from one
    # state with one key give equal losses, another key another loss
    weights = copy.deepcopy(model.state_dict())
    moments = copy.deepcopy(trainer.state.optimizer.state_dict())
    key_losses = []
    for counter in (7, 7, 8):
        _, metrics = step(trainer.state, images, labels, KeyStream(11, counter=counter).next())
        key_losses.append(float(metrics["loss"]))
        model.load_state_dict(weights)
        trainer.state.optimizer.load_state_dict(copy.deepcopy(moments))
    log(f"[models] {DE128} train: non-zero finite gradients on all {len(fusion)} fusion "
        f"parameters; one state, keys (7, 7, 8): losses {key_losses}")
    if not (key_losses[0] == key_losses[1] != key_losses[2]):
        raise SystemExit("the DualEncoder's dropout draws do not follow the step's key")
    return launches, trainer


def models_cli(trainer, rng) -> dict:
    """``cli.main --mode inference`` on the 128³ DualEncoder's YAML over one
    192×192×256 case, from the trained state's checkpoint; the mask equal
    to ``sliding_window_inference`` + ``predict_labels`` + postprocess on the
    same weights voxel for voxel, kernel B's launches to the tile grid."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import tile_count
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from multimodal_organ_segmentation_tpu_torch.utils import nifti
    from multimodal_organ_segmentation_tpu_torch.utils.config import load_config
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

    config = load_config(DE128_YAML)
    Path("outputs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_models_", dir="outputs")).resolve()
    save_checkpoint(trainer.state.tree(), work / "ckpt")
    affine = np.diag([0.9, 0.9, 1.5, 1.0])
    for mod in config.get("data.modalities"):
        save_nifti(rng.standard_normal(VOLUME, np.float32), work / "input" / mod.lower() / "case.nii.gz",
                   affine=affine)
    roi = tuple(config.get("inference.sliding_window.roi_size"))
    overlap = config.get("inference.sliding_window.overlap")
    sw = config.get("inference.batch_size")
    chunks = math.ceil(tile_count(VOLUME, roi, overlap) / sw)
    expect = planned_flash_launches(config.to_dict(), sw, chunks)
    reset_launches(flash_attention)
    wall = _cli(["--mode", "inference", "--config", DE128_YAML, "--checkpoint", str(work / "ckpt"),
                 "--input", str(work / "input"), "--output", str(work / "pred"),
                 "--set", f"experiment.output_dir={work / 'out'}",
                 "--set", f"experiment.log_dir={work / 'logs'}"], "cuda")
    launches = dict(flash_attention.launches)

    model = build_model(config)
    model.load_state_dict(load_checkpoint(work / "ckpt", map_location="cuda")["tree"]["params"])
    vol = torch.from_numpy(np.stack([load_nifti(work / "input" / m.lower() / "case.nii.gz")
                                     for m in config.get("data.modalities")], axis=-1)).cuda()
    ref = library_mask(model, vol, config)
    mask = nifti.load(str(work / "pred" / "case_pred.nii.gz")).dataobj
    same = mask.dtype == np.uint8 and mask.shape == VOLUME and np.array_equal(mask, ref)
    log(f"[models] {DE128} cli: --mode inference over one {VOLUME} case in {wall * 1e3:.1f} ms of "
        f"wall time (model build and checkpoint load included); mask {mask.dtype} {mask.shape}, "
        f"voxels differing from the library path "
        f"{int((mask != ref).sum()) if mask.shape == VOLUME else 'n/a'}: {'ok' if same else 'FAIL'}; "
        f"flash_attention {json.dumps(launches)} expected {json.dumps(expect)}")
    if not same:
        raise SystemExit("the DualEncoder's CLI mask is not the library path's")
    if launches != expect:
        raise SystemExit("the DualEncoder CLI inference's kernel B launches differ from the grid")
    del model, vol
    shutil.rmtree(work)
    return launches


# The [explain] phase: the flagship's three CT+PET cases, the cuts of its
# depth (IG steps of explainability.shap.n_samples: 100, the explain chunk of
# inference.batch_size: 15) and the limits of its checks.
EXPLAIN_CASES = {"large": VOLUME, "small_a": (128, 128, 112), "small_b": (128, 128, 112)}
EXPLAIN_IG_STEPS = 8
EXPLAIN_CHUNK = 4  # tiles a forward + backward: 15 without remat would not fit the card
# f32 tile, kernels against the plain versions: the GradCAM map after ~40
# layers (each op of the kernels a few ulp off: ~1e-5 relative on the
# gradients); the captured probabilities after kernel B at /8 and /16 only.
# The input gradients of this seeded model are ill-conditioned in f32: a
# 1e-7 relative jitter of the input moves the input gradient at x by about
# 2e-3 and the IG map by about 3e-3 (relative L2), which is what the kernels'
# f32 routes move them by too. The input gradient at x (gradient SHAP's, one
# backward away from the jump of F near the mean-image baseline) is held to
# a fixed relative L2 limit, the IG map to 3x its own jitter floor. Each run
# also plants a 1e-4 scale of kernel A's output: GradCAM and the gradient at
# x must fail their limits with it, or the checks could not see such an
# error. A 1e-4 scale of B's output is printed, not held: at this seeded
# init B's output averages v over 1728 or more tokens, which leaves it small
# beside its residual, and the instance norm after the residual removes its
# mean, so the scale moves no map beyond the f32 floor (B is held at its
# shapes by the [kernels] phase).
EXPLAIN_TOL = {"gradcam": 1e-3, "attn_probs": 1e-4, "grad_x": 5e-3}
IG_FLOOR_FACTOR = 3.0
IG_JITTER = 1e-7
PLANTED = 1e-4
# IG's sum against the midpoint sum of central differences of F along the
# same path (the directional derivative IG evaluates at each alpha), f32
IG_FD_RTOL = 1e-2


def explain_config(work: Path, mixed_precision: str = "bf16") -> dict:
    """The flagship's dict with every explainability tool on, on native
    grids, the explain chunk and the IG steps of this phase."""
    cfg = serving_config(work)
    cfg["hardware"]["mixed_precision"] = mixed_precision
    cfg["inference"]["batch_size"] = EXPLAIN_CHUNK
    cfg["explainability"] = {"native_grid": True, "gradcam": {"enabled": True},
                             "attention_maps": {"enabled": True},
                             "shap": {"enabled": True, "n_samples": EXPLAIN_IG_STEPS},
                             "tsne": {"enabled": False}}
    return cfg


def phase_explain(device: str = "cuda") -> dict:
    """``--mode explain``'s library calls on the flagship at full width (the
    card lacks matplotlib and sklearn, so no figure is drawn; the CPU tests
    run the CLI with them): a port checkpoint of a seeded init, three
    synthetic CT+PET cases, per case GradCAM on the last perturbation point,
    attention saliency and IG on the native grid through the sliding window,
    the capture forward and IG on the ROI-resized input, then the pooled
    t-SNE features. Maps finite on each native grid; A's and B's launches
    held to the plans; one f32 tile through the kernels against the plain
    versions and with an error planted in A or B; IG's sum against F's
    differences. Returns the launches."""
    import importlib.util

    import torch

    from multimodal_organ_segmentation_tpu_torch.explainability import (
        AttentionVisualizer,
        GradCAM,
        SHAPAnalyzer,
        TSNEVisualizer,
        perturb_names,
    )
    from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import logits_of
    from multimodal_organ_segmentation_tpu_torch.explainability.runner import (
        discover_cases,
        load_explain_model,
    )
    from multimodal_organ_segmentation_tpu_torch.models import fusion as fusion_module
    from multimodal_organ_segmentation_tpu_torch.models import swin_unetr as swin_unetr_module
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import make_tile_grid
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

    absent = [m for m in ("matplotlib", "sklearn") if importlib.util.find_spec(m) is None]
    log(f"[explain] host renderers run: none (the figures and the t-SNE embedding are drawn "
        f"by the CPU tests of --mode explain); absent here: {absent or 'none'}")
    log(f"[explain] cuts: IG steps {EXPLAIN_IG_STEPS} (explainability.shap.n_samples: 100), "
        f"explain chunk {EXPLAIN_CHUNK} tiles (inference.batch_size: 15); t-SNE: features only")
    Path("outputs").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_explain_", dir="outputs")).resolve()
    cfg = explain_config(work)
    config = ConfigNode(cfg)
    seed = cfg["experiment"]["seed"]
    modalities = cfg["data"]["modalities"]
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, train=True,
                        generator=torch.Generator().manual_seed(seed))
    save_checkpoint({"step": 0, "params": model.state_dict(), "opt_state": None,
                     "ema_params": None}, work / "ckpt")
    del model
    rng = np.random.default_rng(seed)
    for case, shape in EXPLAIN_CASES.items():
        save_nifti(rng.standard_normal(shape, np.float32), work / "input" / "ct" / f"{case}.nii.gz")
        save_nifti(2 * np.abs(rng.standard_normal(shape, np.float32)),
                   work / "input" / "pet" / f"{case}.nii.gz")
    model = load_explain_model(config, work / "ckpt", device)
    log(f"[explain] checkpoint (seed {seed}) and {len(EXPLAIN_CASES)} cases "
        f"{list(EXPLAIN_CASES.values())} written, model loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    roi = tuple(cfg["model"]["backbone"]["img_size"])
    sw = dict(roi_size=roi, overlap=cfg["inference"]["sliding_window"]["overlap"],
              sw_batch_size=EXPLAIN_CHUNK)
    target = perturb_names(model)[-1]
    cam_gen, viz = GradCAM(model, [target]), AttentionVisualizer(model)
    shap = SHAPAnalyzer(model, n_steps=EXPLAIN_IG_STEPS)
    times: dict = {}

    def timed(tool, fn):
        _sync(device)
        start = time.perf_counter()
        out = fn()
        _sync(device)
        times.setdefault(tool, []).append(time.perf_counter() - start)
        return out

    reset_launches(window_mha, flash_attention)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    samples, first_x = [], None
    for case, mods in discover_cases(work / "input", modalities).items():
        image = np.stack([load_nifti(mods[m]) for m in modalities], axis=-1)
        x = resize_linear(torch.from_numpy(image).to(device), roi, (0, 1, 2))[None]
        first_x = x if first_x is None else first_x
        samples.append({"image": x[0]})
        maps = {}
        cam = timed("gradcam native", lambda: cam_gen.generate_native(image, 1, **sw))[target]
        maps[f"{case}_gradcam_{target.replace('/', '_')}.nii.gz"] = cam
        sals = timed("attention native", lambda: viz.saliency_native(image, **sw))
        maps.update({f"{case}_attention_native_{i}.nii.gz": s for i, s in enumerate(sals)})
        probs = timed("attention capture", lambda: viz.capture(x))
        attr = timed("ig", lambda: shap.integrated_gradients(x, 1))
        attr_n = timed("ig native", lambda: shap.integrated_gradients_native(image, 1, **sw))
        maps.update({f"{case}_ig_native_{m.lower()}.nii.gz": attr_n[..., i]
                     for i, m in enumerate(modalities)})
        bad = [n for n, v in maps.items() if v.shape != image.shape[:3] or not np.isfinite(v).all()]
        bad += [n for n, v in probs.items() if not np.isfinite(v).all()]
        if len(sals) != 4 or bad or not np.isfinite(attr).all() or attr.shape != tuple(x.shape):
            raise SystemExit(f"[explain] {case}: maps not finite or not on the native grid: "
                             f"{bad}, {len(sals)} saliency maps")
        for name, v in maps.items():
            save_nifti(v, work / "explain" / name)
        log(f"[explain] {case} {image.shape}: {len(maps)} maps on the native grid, finite: "
            f"GradCAM on {target} in [{cam.min():.3f}, {cam.max():.3f}], {len(sals)} saliency "
            f"maps, IG native in [{attr_n.min():.3e}, {attr_n.max():.3e}]; {len(probs)} "
            f"attention tensors captured; IG on the 96^3 resize sums to {attr.sum():.4e}")
    feats = timed("tsne features", lambda: TSNEVisualizer(model).collect(samples))["features"]
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    if feats.shape != (len(samples), 16 * cfg["model"]["backbone"]["feature_size"]) or not \
            np.isfinite(feats).all():
        raise SystemExit(f"[explain] t-SNE features {feats.shape} not finite or not pooled")
    log("[explain] wall s per tool (one per case): " + "; ".join(
        f"{tool} {[round(t, 2) for t in ts]}" for tool, ts in times.items()))
    log(f"[explain] peak device memory {peak:.2f} GiB; t-SNE features {feats.shape}")

    # launches: forwards through A and B (GradCAM's chunks, IG's chunks x
    # steps, and on one tile IG's steps and the t-SNE forward) and through B
    # alone (the capture forwards: the saliency chunks and the one-tile capture)
    chunks = sum(make_tile_grid(shape, roi, sw["overlap"], EXPLAIN_CHUNK)[0].shape[0]
                 for shape in EXPLAIN_CASES.values())
    n, k = EXPLAIN_IG_STEPS, len(EXPLAIN_CASES)
    expect = add_counts(predicted_launches(EXPLAIN_CHUNK, chunks * (1 + n), chunks * (2 + n)),
                        predicted_launches(1, k * (n + 1), k * (n + 2)))
    log(f"[explain] kernels {json.dumps(launches)} expected {json.dumps(expect)} ({chunks} "
        f"chunks of {EXPLAIN_CHUNK} tiles, {k} one-tile inputs)")
    if launches != expect or any(c for counts in launches.values()
                                 for route, c in counts.items() if route != "mma"):
        raise SystemExit("[explain] kernel launches differ from the plans or left mma")
    reset_launches(window_mha, flash_attention)
    viz.capture(first_x)
    capture_only, expect = attention_launches(), predicted_launches(1, 0, 1)
    log(f"[explain] one capture forward launches {json.dumps(capture_only)} expected "
        f"{json.dumps(expect)}")
    if capture_only != expect:
        raise SystemExit("[explain] the capture forward must launch B and not A")
    del model, cam_gen, viz, shap, samples
    torch.cuda.empty_cache()

    # one f32 tile (TF32 off): every map through the kernels against the same
    # map through the plain versions, the same with a planted error in A or
    # B, then IG's sum against F's differences
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    m32 = load_explain_model(ConfigNode(explain_config(work, "fp32")), work / "ckpt", device)
    x = first_x.float()

    def f32_maps(xin, capture=True):
        shap32 = SHAPAnalyzer(m32, EXPLAIN_IG_STEPS)
        out = {"gradcam": GradCAM(m32, [target]).generate(xin)[target],
               "grad_x": shap32._grad(xin, 1).cpu().numpy(),
               "ig": shap32.integrated_gradients(xin)}
        if capture:
            out["attn_probs"] = AttentionVisualizer(m32).capture(xin)
        return out

    maps = {}
    for use in (False, True):
        set_use_kernels(m32, use)
        reset_launches(window_mha, flash_attention)
        maps["kernels" if use else "plain"] = f32_maps(x)
        routes = attention_launches()
        if use and any(route != "f32" and c for counts in routes.values()
                       for route, c in counts.items()):
            raise SystemExit(f"[explain] f32 tile left the f32 routes: {routes}")
    jitter = 1 + IG_JITTER * torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    maps["jitter"] = f32_maps(x * jitter.to(device), capture=False)
    for kernel, module, name in (("A", swin_unetr_module, "window_mha"),
                                 ("B", fusion_module, "multi_head_attention")):
        op = getattr(module, name)
        setattr(module, name, lambda *a, _op=op, **k: _op(*a, **k) * (1 + PLANTED))
        try:
            maps[f"planted {kernel}"] = f32_maps(x, capture=False)
        finally:
            setattr(module, name, op)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    plain = maps["plain"]
    errs = {run: {"gradcam": float(np.abs(maps[run]["gradcam"] - plain["gradcam"]).max()),
                  "grad_x": rel(maps[run]["grad_x"], plain["grad_x"]),
                  "ig": rel(maps[run]["ig"], plain["ig"])}
            for run in ("kernels", "jitter", "planted A", "planted B")}
    errs["kernels"]["attn_probs"] = max(float(np.abs(maps["kernels"]["attn_probs"][name] - v).max())
                                        for name, v in plain["attn_probs"].items())
    limits = dict(EXPLAIN_TOL, ig=IG_FLOOR_FACTOR * errs["jitter"]["ig"])
    for name, err in errs["kernels"].items():
        others = "; ".join(f"{run} {errs[run][name]:.3e}" for run in ("jitter", "planted A",
                                                                      "planted B")
                           if name in errs[run])
        log(f"[explain] f32 96^3 tile against plain, {name} "
            f"{'max |diff|' if name in ('gradcam', 'attn_probs') else 'relative L2'}: kernels "
            f"{err:.3e} (limit {limits[name]:.3e}) {'ok' if err <= limits[name] else 'FAIL'}"
            + (f"; {others}" if others else ""))
    if any(err > limits[name] for name, err in errs["kernels"].items()):
        raise SystemExit("[explain] a map through the kernels disagrees with the plain versions")
    blind = [name for name in ("gradcam", "grad_x") if errs["planted A"][name] <= limits[name]]
    log(f"[explain] a planted {PLANTED:.0e} scale of A's output fails "
        f"{[n for n in ('gradcam', 'grad_x', 'ig') if errs['planted A'][n] > limits[n]]}; "
        f"of B's {[n for n in ('gradcam', 'grad_x', 'ig') if errs['planted B'][n] > limits[n]]} "
        f"(not held: B's output, an average over all tokens, is small beside its residual and "
        f"the instance norm after it removes its mean)")
    if blind:
        raise SystemExit(f"[explain] {blind} cannot see a planted {PLANTED:.0e} error in A")
    set_use_kernels(m32, True)

    base = SHAPAnalyzer._baseline(x)

    def score(alpha: float) -> float:
        with torch.no_grad():
            return float(logits_of(m32(base + alpha * (x - base)))[..., 1].double().sum())

    h = 0.01 / n
    riemann = sum((score((j + 0.5) / n + h) - score((j + 0.5) / n - h)) / (2 * h)
                  for j in range(n)) / n
    total = float(maps["kernels"]["ig"].astype(np.float64).sum())
    completeness = score(1.0) - score(0.0)
    gap_fd = abs(total - riemann) / abs(riemann)
    log(f"[explain] IG ({n} midpoint steps, f32 tile): sum of attributions {total:.6e}; midpoint "
        f"sum of F's central differences along the path {riemann:.6e}: relative gap "
        f"{gap_fd:.3e} (tol {IG_FD_RTOL:.0e}) {'ok' if gap_fd <= IG_FD_RTOL else 'FAIL'}; "
        f"F(x) - F(baseline) {completeness:.6e}: relative gap "
        f"{abs(total - completeness) / abs(completeness):.3e} (not held: F jumps within "
        f"alpha < 0.01 of the mean-image baseline, which {n} midpoints do not resolve)")
    if gap_fd > IG_FD_RTOL:
        raise SystemExit("[explain] IG's sum disagrees with F's differences along its path")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del m32
    shutil.rmtree(work)
    return launches


def phase_analysis(case: Path, device: str = "cuda") -> None:
    """``cli.main --mode analysis --generate-report`` on the [cli] phase's
    predicted mask of the 192×192×256 case and a synthetic SUV volume on its
    grid (histogram figures off: the card has no matplotlib). The SUV, TMTV
    and TLG numbers against the same functions on CPU tensors, the masks
    equal, the CSV and XLSX columns those of the JAX package's tables."""
    import zipfile

    from multimodal_organ_segmentation_tpu_torch.analysis import SUVAnalyzer, TMTVAnalyzer
    from multimodal_organ_segmentation_tpu_torch.utils import nifti
    from multimodal_organ_segmentation_tpu_torch.utils.config import load_config
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti

    img = nifti.load(str(case / "flagship_pred.nii.gz"))
    seg = np.asarray(img.dataobj)
    rng = np.random.default_rng(FLAGSHIP["experiment"]["seed"])
    suv = rng.uniform(0.3, 1.5, seg.shape).astype(np.float32)
    suv[seg == 5] = rng.normal(2.0, 0.3, int((seg == 5).sum()))
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in seg.shape], indexing="ij"), -1)
    for center, radius, value in (((60, 70, 90), 8, 9.0), ((130, 120, 180), 12, 5.5),
                                  ((100, 50, 60), 5, 3.2)):
        suv[((grid - center) ** 2).sum(-1) <= radius**2] = value
    del grid
    save_nifti(suv, case / "pet_suv.nii.gz", affine=img.affine)
    out, ref_out = case.parent / "out", case.parent / "cpu"
    wall = _cli(["--mode", "analysis", "--config", FLAGSHIP_YAML, "--input", str(case), "--output",
                 str(out), "--suv-analysis", "--tmtv-analysis", "--generate-report", "--set",
                 "analysis.histogram.enabled=false", "--set",
                 f"experiment.log_dir={case.parent / 'logs'}"], device)
    config = load_config(FLAGSHIP_YAML)
    organs = SUVAnalyzer(config, "cpu").analyze(case, ref_out)["organs"]
    tmtv = TMTVAnalyzer(config, "cpu").analyze(case, ref_out)

    def rows(path):
        with open(path) as f:
            return [line.rstrip("\n").split(",") for line in f]

    suv_columns = ["organ", "label_id", "suv_max", "suv_mean", "suv_std", "suv_median",
                   "suv_min", "volume_ml", "volume_voxels", "suv_40_volume", "suv_50_volume",
                   "suv_60_volume"]
    tmtv_columns = []
    for v in tmtv.values():
        tmtv_columns.extend(c for c in ["metric", *v] if c not in tmtv_columns)
    worst = 0.0
    for table, columns in (("suv_analysis", suv_columns), ("tmtv_analysis", tmtv_columns)):
        got, ref = rows(out / f"{table}.csv"), rows(ref_out / f"{table}.csv")
        with zipfile.ZipFile(out / f"{table}.xlsx") as z:
            sheet = z.read("xl/worksheets/sheet1.xml").decode()
        header = re.findall(r"<is><t>([^<]*)</t></is>", sheet)[:len(columns)]
        if got[0] != columns or ref[0] != columns or header != columns or len(got) != len(ref) \
                or sheet.count("<row ") != len(ref):
            raise SystemExit(f"[analysis] {table}: columns {got[0]} / xlsx {header}, want "
                             f"{columns}; {len(got)} rows, {len(ref)} on the CPU")
        for a, b in zip(ref[1:], got[1:]):
            for u, v in zip(a, b):
                try:
                    worst = max(worst, abs(float(v) - float(u)) / max(abs(float(u)), 1e-12))
                except ValueError:
                    if u != v:
                        raise SystemExit(f"[analysis] {table}: {v!r} against {u!r} on the CPU")
    masks = [m for m in ("tmtv_absolute", "tmtv_percentage", "tmtv_liver_based")
             if not np.array_equal(load_nifti(out / f"{m}.nii.gz"),
                                   load_nifti(ref_out / f"{m}.nii.gz"))]
    reports = [r for r in ("report.md", "report.html", "report.docx") if not (out / r).exists()]
    log(f"[analysis] --mode analysis on {seg.shape} (the [cli] mask, labels "
        f"{sorted(np.unique(seg).tolist())}) in {wall:.2f} s of wall time: {len(organs)} organs; "
        f"TMTV absolute {tmtv['absolute']['volume_ml']:.3f} ml (SUVmax "
        f"{tmtv['absolute']['suv_max']:.3f}, SUVpeak {tmtv['absolute'].get('suv_peak', 0):.4f}), "
        f"percentage {tmtv['percentage']['volume_ml']:.3f} ml, liver-based "
        f"{tmtv['liver_based']['volume_ml']:.3f} ml, TLG {tmtv['tlg']['tlg']:.3f}; numbers "
        f"against the CPU tensors: max relative |diff| {worst:.3e} (tol 1e-6); masks differing "
        f"{masks}; CSV/XLSX columns as the JAX tables; reports missing {reports}")
    if worst > 1e-6 or masks or reports:
        raise SystemExit("[analysis] the card's analysis differs from the CPU's or lacks a file")
    shutil.rmtree(case.parent)


# The [preprocess] study: a PET/CT series pair at a scanner's sizes, written
# with the port's DICOM writer from the seed. CT: 512×512 pixels of 0.9766 mm,
# 280 slices of 2.5 mm, int16 with a rescale intercept; PET: 192×192 of
# 4.0728 mm, 214 slices of 3.27 mm, uint16 with a rescale slope and the tags
# SUV reads. The PET's anatomy is the CT's moved by PREP_SHIFT_MM, under
# another intensity map, so only mutual information can find it.
PREP_CT = ((512, 512, 280), (0.9766, 0.9766, 2.5))
PREP_PET = ((192, 192, 214), (4.0728, 4.0728, 3.27))
PREP_SHIFT_MM = (4.2, -3.3, 5.0)
PREP_CONFIG = "configs/default.yaml"  # target spacing 1.5×1.5×2.0 mm, translation + MI
PET_SLOPE = 1.25
PET_TAGS = {"PatientWeight": 75.0, "PatientSize": 1.75, "AcquisitionTime": "093000",
            "SeriesTime": "093000"}
PET_DOSE = {"RadionuclideTotalDose": 3.7e8, "RadionuclideHalfLife": 6586.2,
            "RadiopharmaceuticalStartTime": "083000"}
# (centre mm, semi-axes mm, CT HU, PET Bq/ml), painted in order over air
# (-1000 HU, 0 Bq/ml); the label of each is its index + 1
ANATOMY = (
    ((0, 0, 0), (165, 115, 330), 40, 2500),  # body
    ((-70, -10, 120), (55, 60, 110), -820, 600),  # lungs
    ((70, -10, 120), (55, 60, 110), -820, 600),
    ((15, 20, 90), (45, 40, 45), 45, 6000),  # heart
    ((-55, 10, -20), (70, 55, 65), 60, 7500),  # liver
    ((70, 10, -10), (30, 35, 45), 50, 5500),  # spleen
    ((-65, 50, -90), (25, 25, 45), 35, 9000),  # kidneys
    ((65, 50, -90), (25, 25, 45), 35, 9000),
    ((0, 20, -270), (35, 30, 30), 10, 30000),  # bladder
    ((0, 85, 0), (15, 15, 320), 700, 1500),  # spine
    ((0, 0, 290), (70, 85, 45), 35, 15000),  # brain
    ((-30, -40, 40), (9, 9, 9), 30, 20000),  # lesions
    ((40, 30, -150), (6, 6, 6), 30, 25000),
)
# register_arrays at the resampled CT's full grid, each method against a
# planted transform (mean squares), held to the JAX package's TRE gates
# (tests/test_registration_tre.py:129-149): absolute voxels, or a share of
# the initial TRE for the deformable
PREP_RECOVER = {"rigid": (0.5, None), "affine": (0.7, None), "deformable": (None, 0.4)}
PREP_RECOVER_ITERS = 100
# card against CPU: one register_arrays a method at 48³, 20 iterations, the
# default pyramid; MI's trajectories are chaotic across levels (its f32
# gradient moves by 3e-5 relative with the order of summation, and Adam
# amplifies that), so MI is held on one level at lr 0.1
PREP_PAIR_CASES = (("translation", "correlation", {}), ("rigid", "correlation", {}),
                   ("affine", "mean_squares", {}), ("deformable", "mean_squares", {}),
                   ("translation", "mattes_mutual_information",
                    {"shrink_factors": [1], "smoothing_sigmas": [0], "lr": 0.1}))
PREP_PAIR_SHAPE, PREP_PAIR_ITERS = (48, 48, 48), 20
PREP_PAIR_TOL = 1e-3  # voxels, final parameters, card against CPU


def study_origin(shape, spacing) -> list:
    """Patient position of voxel 0, centring the volume on the origin;
    two decimals, so that the DICOM writer's six significant digits keep it."""
    return [round(-(n - 1) / 2 * s, 2) for n, s in zip(shape, spacing)]


EDGE_MM = (0.5, 3.0)  # CT's and PET's edge widths: the scanners' resolutions, roughly


def anatomy(shape, spacing, shift_mm, column: int, gen, device: str):
    """The phantom on a grid as a float32 tensor, with the anatomy moved by
    ``shift_mm``: CT HU (column 0; 12 HU of noise inside the body), PET Bq/ml
    (column 1) or labels (column 2). Images blend each organ in over a
    logistic edge of ``EDGE_MM`` (an edge sampled sharp at the PET's 3.27 mm
    slices would move MI's optimum by its aliasing); labels are sharp. The
    PET has no noise: linear interpolation at a fractional shift averages
    the moving image's noise away, which raises MI there (MI's interpolation
    artifact), and 10% noise moved the optimum 0.4 voxel off a zero shift."""
    import torch

    axes = []
    for a, (n, s, o, d) in enumerate(zip(shape, spacing, study_origin(shape, spacing), shift_mm)):
        v = o + torch.arange(n, dtype=torch.float64, device=device) * s - d
        axes.append(v.reshape([-1 if b == a else 1 for b in range(3)]))
    empty = (-1000.0, 0.0, 0.0)[column]
    vol = torch.full(tuple(shape), empty, dtype=torch.float32, device=device)
    body = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for label, (center, semi, *values) in enumerate(ANATOMY, start=1):
        rho = torch.sqrt(sum(((x - c) / r) ** 2 for x, c, r in zip(axes, center, semi)))
        value = float((*values, label)[column])
        if column == 2:
            vol[rho <= 1] = value
            continue
        # signed distance to the surface, roughly, in mm (positive inside)
        inside = torch.sigmoid((1 - rho) * min(semi) / EDGE_MM[column]).float()
        vol += (value - vol) * inside
        body |= rho <= 1
    if column == 2:
        return vol
    if column == 1:
        return vol
    return vol + 12.0 * torch.randn(tuple(shape), generator=gen, device=device) * body


def write_study(root: Path, ct=PREP_CT, pet=PREP_PET, shift_mm=PREP_SHIFT_MM, seed: int = 42,
                device: str = "cuda") -> np.ndarray:
    """``root/CT`` and ``root/PET`` DICOM series of the phantom; returns the
    CT's stored int16 pixels ``[rows, cols, slices]``."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.preprocessing.dicom import dcmwrite

    gen = torch.Generator(device=device).manual_seed(seed)
    patient = {"PatientID": "SMOKE01", "PatientName": "Smoke^Study", "PatientSex": "M",
               "StudyDate": "20260101", "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
               "SamplesPerPixel": 1, "BitsAllocated": 16}
    ct_stored = torch.round(anatomy(*ct, (0, 0, 0), 0, gen, device) + 1024).to(torch.int16)
    pet_stored = torch.round(anatomy(*pet, shift_mm, 1, gen, device) / PET_SLOPE).clamp(0, 65535)
    series = (
        ("CT", ct, ct_stored.cpu().numpy(),
         {"Modality": "CT", "RescaleSlope": 1.0, "RescaleIntercept": -1024.0,
          "PixelRepresentation": 1}),
        ("PET", pet, pet_stored.to(torch.int32).cpu().numpy().astype(np.uint16),
         {"Modality": "PT", "RescaleSlope": PET_SLOPE, "RescaleIntercept": 0.0,
          "PixelRepresentation": 0, **PET_TAGS,
          "RadiopharmaceuticalInformationSequence": [PET_DOSE]}),
    )
    for mod, (shape, spacing), pixels, tags in series:
        origin = study_origin(shape, spacing)
        for k in range(shape[2]):
            dcmwrite(root / mod / f"{mod.lower()}_{k:04d}.dcm",
                     {**patient, **tags, "InstanceNumber": k + 1, "Rows": shape[0],
                      "Columns": shape[1], "PixelSpacing": list(spacing[:2]),
                      "SliceThickness": spacing[2],
                      "ImagePositionPatient": [origin[0], origin[1], origin[2] + k * spacing[2]]},
                     pixels[:, :, k])
    return series[0][2]


def carried_shift(ct, pet, target, shift_mm) -> np.ndarray:
    """The planted shift as the resampled grids carry it, at the fixed grid's
    centre, in fixed voxels. The spacing resample keeps scipy zoom's corner
    mapping (``in - 1`` input steps over ``out - 1`` output steps) and writes
    the target spacing into the affine, so a resampled voxel's true spacing
    is ``(n - 1)·s / (m - 1)``, not the target: registration through the
    affines then sees the planted shift plus the two grids' scale errors."""
    out = []
    for a, t in enumerate(target):
        (n_c, s_c), (n_p, s_p) = ((v[0][a], v[1][a]) for v in (ct, pet))
        m_c, m_p = (max(1, int(round(n * s / t))) for n, s in ((n_c, s_c), (n_p, s_p)))
        r_c = (n_c - 1) * s_c / (m_c - 1)
        r_p = (n_p - 1) * s_p / (m_p - 1)
        o_c, o_p = study_origin([n_c], [s_c])[0], study_origin([n_p], [s_p])[0]
        i = (m_c - 1) / 2
        # fixed voxel i lies at o_c + i·r_c; its PET partner at o_c + (i + t)·t_a
        # in the affines, at o_p + j·r_p truly, with j = (o_c - o_p + (i + t)·t_a) / t_a
        out.append((o_c - o_p + i * r_c + shift_mm[a]) / r_p - (o_c - o_p) / t - i)
    return np.asarray(out)


def tre_phantom(shape=(48, 48, 48), seed=0) -> np.ndarray:
    """The JAX package's registration phantom (tests/test_registration_tre.py)."""
    rng = np.random.default_rng(seed)
    coords = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij"))
    vol = 0.1 * coords[0] / shape[0] + 0.15 * coords[1] / shape[1]
    for _ in range(12):
        c = rng.uniform(8, np.asarray(shape) - 8)
        s = rng.uniform(2.5, 6.0)
        a = rng.uniform(0.5, 1.5)
        d2 = ((coords - c[:, None, None, None]) ** 2).sum(0)
        vol = vol + a * np.exp(-d2 / (2 * s * s))
    return vol.astype(np.float32)


def planted_params(method: str, shape, device) -> dict:
    """A planted misalignment of 2 to 4 voxels at the landmarks of a grid of
    ``shape``: the JAX TRE test's at 48³, rotations and affine terms scaled
    down with the grid's half-width."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.preprocessing.registration import init_params

    lever = min(shape) / 48
    p = init_params(method, device=device)
    tensor = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    if method == "translation":
        p["t"] = tensor([3.2, -2.4, 1.7])
    elif method == "rigid":
        p["t"], p["r"] = tensor([2.1, -1.4, 0.8]), tensor([0.06, -0.04, 0.08]) / lever
    elif method == "affine":
        p["t"] = tensor([1.6, -1.1, 0.9])
        p["A"] = tensor([[0.04, 0.02, 0.0], [-0.01, -0.03, 0.015], [0.0, 0.01, 0.05]]) / lever
    elif method == "deformable":
        g = p["grid"].shape[0]
        gx = np.linspace(0, np.pi, g)
        field = np.zeros((g, g, g, 3), np.float32)
        field[..., 0] = 3.0 * np.sin(gx)[:, None, None] * np.cos(gx)[None, :, None]
        field[..., 1] = -2.4 * np.cos(gx)[:, None, None] * np.sin(gx)[None, None, :]
        field[..., 2] = 2.0 * np.sin(gx)[None, :, None] * np.sin(gx)[None, None, :]
        p["grid"] = tensor(field)
    return p


def planted_tre(method: str, moving, true_p: dict, reg, seed: int = 1, mask=None) -> tuple:
    """Warp ``moving`` (a tensor) by ``true_p``, register it back with
    ``reg``; returns the initial and the recovered TRE in voxels over 24
    landmarks, as the JAX TRE test measures them, and the transform. The
    landmarks are drawn at least 10 voxels inside the grid and, given a
    ``mask``, where it holds (in the anatomy: air carries no signal)."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.preprocessing import registration as R

    shape = tuple(moving.shape)
    dev = moving.device
    center = torch.tensor([(s - 1) / 2 for s in shape], device=dev)

    def coord_map(p):
        with torch.no_grad():
            return R.transform_coords(p, R._identity_coords(shape, dev), method, center, shape)

    true_map = coord_map(true_p)
    with torch.no_grad():
        fixed = R._sample(moving, true_map)
    _, transform = reg.register_arrays(fixed, moving, method=method)
    rec_p = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in transform["params"].items()}
    rec_map = coord_map(rec_p)
    rng, lms = np.random.default_rng(seed), []
    while len(lms) < 24:
        p = rng.integers(10, np.asarray(shape) - 10)
        if mask is None or mask[tuple(p)]:
            lms.append(p)
    lms = np.stack(lms)
    idx = tuple(torch.from_numpy(lms[:, a]).to(dev) for a in range(3))
    true_pts = true_map[:, idx[0], idx[1], idx[2]].cpu().numpy()
    rec_pts = rec_map[:, idx[0], idx[1], idx[2]].cpu().numpy()
    initial = float(np.linalg.norm(true_pts - lms.T, axis=0).mean())
    recovered = float(np.linalg.norm(true_pts - rec_pts, axis=0).mean())
    return initial, recovered, transform


def phase_preprocess(device: str = "cuda", ct=PREP_CT, pet=PREP_PET, shift_mm=PREP_SHIFT_MM,
                     spacing=None, root: Path = Path("outputs")) -> None:
    """``cli.main --mode preprocess`` on the study (convert, resample, SUV,
    register), with every output checked; then rigid, affine and deformable
    recovery at the resampled CT's full grid, and one ``register_arrays`` a
    method on the card against the same on CPU tensors. (``device="cpu"``
    with a coarser study and ``spacing`` rehearses the phase on the CPU.)"""
    import torch

    from multimodal_organ_segmentation_tpu_torch.preprocessing import (
        DicomConverter,
        ImageRegistration,
    )
    from multimodal_organ_segmentation_tpu_torch.preprocessing.suv_calculator import (
        decay_factor,
        suv_factor,
    )
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode, load_config
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_json, load_nifti, save_nifti

    root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_preprocess_", dir=root)).resolve()
    study, out, logs = work / "study", work / "processed", work / "logs"
    t0 = time.perf_counter()
    ct_stored = write_study(study, ct, pet, shift_mm, device=device)
    log(f"[preprocess] study written in {time.perf_counter() - t0:.2f} s: CT {ct[0]} of "
        f"{ct[1]} mm, PET {pet[0]} of {pet[1]} mm, the PET's anatomy moved {shift_mm} mm")

    # the CT's NIfTI before the resample: the stored pixels × slope + intercept
    raw = load_nifti(DicomConverter().convert(study / "CT", work / "raw", "CT"))
    want = ct_stored.astype(np.float32) * 1.0 + -1024.0
    ct_exact = raw.shape == want.shape and np.array_equal(raw, want)
    del raw, want

    config = load_config(PREP_CONFIG)
    target = list(spacing or config.get("data.preprocessing.ct.target_spacing"))
    sets = [f"experiment.log_dir={logs}"]
    if spacing:
        sets += [f"data.preprocessing.{m}.target_spacing={target}" for m in ("ct", "pet")]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wall = _cli(["--mode", "preprocess", "--config", PREP_CONFIG, "--input", str(study),
                 "--output", str(out), *[a for kv in sets for a in ("--set", kv)]], device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
    messages = [line.split(" | ")[-1]
                for line in _log_lines(next(logs.rglob("preprocess.log")), 0)]
    stages = [m.split("; ")[0] for m in messages
              if re.match(r"(\w+: (convert|resample|suv)|register) [\d.]+ s", m)]
    pyramid = ast.literal_eval(next(m for m in messages if m.startswith("register ")).split(
        "pyramid ")[1])
    per_iter = {lv["shape"]: round(lv["seconds"] / max(lv["iterations"], 1), 5) for lv in pyramid}

    # grids and affines against the formula
    grids, bad = {}, []
    for mod, (shape, sp) in (("CT", ct), ("PET", pet)):
        vol, aff = load_nifti(out / mod / f"{mod.lower()}.nii.gz", return_affine=True)
        want_shape = tuple(max(1, int(round(n * s / t))) for n, s, t in zip(shape, sp, target))
        want_aff = np.diag([*target, 1.0])
        want_aff[:3, 3] = study_origin(shape, sp)
        grids[mod] = vol.shape
        if vol.shape != want_shape or not np.allclose(aff, want_aff, rtol=0, atol=1e-4):
            bad.append(f"{mod} {vol.shape} {aff.tolist()}, want {want_shape} {want_aff.tolist()}")
    del vol

    # every SUV volume: suv_factor × the resampled PET
    pet_vol = load_nifti(out / "PET" / "pet.nii.gz")
    dose = PET_DOSE["RadionuclideTotalDose"] * decay_factor(
        PET_DOSE["RadiopharmaceuticalStartTime"], PET_TAGS["AcquisitionTime"],
        PET_DOSE["RadionuclideHalfLife"])
    suv_err = {}
    for method in config.get("analysis.suv.methods"):
        ref = pet_vol * suv_factor(method, dose, PET_TAGS["PatientWeight"],
                                   PET_TAGS["PatientSize"], "M")
        got = load_nifti(out / "PET" / f"pet_suv_{method}.nii.gz")
        suv_err[method] = float(np.abs(got - ref).max() / np.abs(ref).max())
    del pet_vol, ref, got

    # the planted translation, in voxels of the fixed grid
    transform = load_json(out / "PET" / "pet_transform.json")
    t = np.asarray(transform["params"]["t"])
    planted_t = np.asarray(shift_mm) / np.asarray(target)
    want_t = carried_shift(ct, pet, target, shift_mm)
    tre = float(np.linalg.norm(t - want_t))
    registered = load_nifti(out / "PET" / "pet_registered.nii.gz").shape

    # a label map carried through the transform: nearest keeps its labels
    gen = torch.Generator(device=device).manual_seed(0)
    pet_shape = grids["PET"]
    labels = anatomy(pet_shape, target, shift_mm, 2, gen, device).to(torch.uint8).cpu().numpy()
    pet_aff = np.diag([*target, 1.0])
    pet_aff[:3, 3] = study_origin(*pet)
    save_nifti(labels, work / "labels.nii.gz", affine=pet_aff)
    reg = ImageRegistration(config, device)
    reg.apply_transform(work / "labels.nii.gz", out / "PET" / "pet_transform.json",
                        work / "labels_ct.nii.gz", reference_path=out / "CT" / "ct.nii.gz",
                        interpolation="nearest", dtype=np.uint8)
    warped = load_nifti(work / "labels_ct.nii.gz", dtype=np.uint8)
    label_sets = sorted(np.unique(labels).tolist()), sorted(np.unique(warped).tolist())
    del labels, warped

    log(f"[preprocess] --mode preprocess in {wall:.2f} s of wall time, peak device memory "
        f"{peak:.2f} GiB; stages: {stages}; s per registration iteration by level {per_iter}")
    log(f"[preprocess] CT NIfTI = stored pixels x slope + intercept: {ct_exact}; grids {grids} "
        f"(bad: {bad}); SUV max relative |diff| from suv_factor x PET {suv_err} (tol 1e-6)")
    log(f"[preprocess] translation {t.tolist()}: TRE {tre:.4f} voxel (gate 0.6) against the "
        f"planted shift as the resampled grids carry it at the centre {want_t.tolist()}, "
        f"{float(np.linalg.norm(t - planted_t)):.4f} against the shift as planted "
        f"{planted_t.tolist()}; pet_registered {registered}, transform keys {sorted(transform)}, "
        f"final metric {transform['final_metric']:.6f}; labels {label_sets[0]} -> "
        f"{label_sets[1]} (nearest, uint8)")
    if not ct_exact or bad or max(suv_err.values()) > 1e-6 or tre >= 0.6 \
            or registered != grids["CT"] or label_sets[0] != label_sets[1] \
            or sorted(transform) != ["final_metric", "method", "metric", "params"]:
        raise SystemExit("[preprocess] a preprocess output is wrong")

    # rigid, affine, deformable at the full grid against planted transforms
    ct_vol = load_nifti(out / "CT" / "ct.nii.gz")
    body = ct_vol > -900
    moving = torch.from_numpy(ct_vol).to(device)
    del ct_vol
    failed = []
    for method, (gate_abs, gate_share) in PREP_RECOVER.items():
        reg = ImageRegistration(ConfigNode({"data": {"registration": {
            "method": method, "metric": "mean_squares", "iterations": PREP_RECOVER_ITERS,
            "lr": 0.5}}}), device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        initial, rec, _ = planted_tre(method, moving, planted_params(method, moving.shape, device),
                                      reg, mask=body)
        seconds = time.perf_counter() - t1
        gate = gate_abs if gate_abs is not None else gate_share * initial
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
        per_iter = [round(lv["seconds"] / max(lv["iterations"], 1), 5) for lv in reg.levels]
        log(f"[preprocess] {method} at {tuple(moving.shape)}, {PREP_RECOVER_ITERS} iterations a "
            f"level: TRE {initial:.3f} -> {rec:.4f} voxel (gate {gate:.3f}) in {seconds:.2f} s; "
            f"s per iteration by level {per_iter} at {[lv['shape'] for lv in reg.levels]}; peak "
            f"{peak:.2f} GiB")
        if not rec < gate:
            failed.append(method)
    del moving, body
    if failed:
        raise SystemExit(f"[preprocess] {failed} missed the TRE gate at the full grid")

    # the card against CPU tensors, the same port function
    phantom = tre_phantom(PREP_PAIR_SHAPE)
    worst = 0.0
    for method, metric, extra in PREP_PAIR_CASES:
        cfg = ConfigNode({"data": {"registration": {
            "method": method, "metric": metric, "iterations": PREP_PAIR_ITERS, **extra}}})
        params, tres = {}, {}
        for dev in (device, "cpu"):
            *tres[dev], transform = planted_tre(
                method, torch.from_numpy(phantom).to(dev),
                planted_params(method, PREP_PAIR_SHAPE, dev), ImageRegistration(cfg, dev))
            params[dev] = {k: np.asarray(v) for k, v in transform["params"].items()}
        err = max(float(np.abs(params[device][k] - params["cpu"][k]).max()) for k in params["cpu"])
        worst = max(worst, err)
        log(f"[preprocess] {method} / {metric} at {PREP_PAIR_SHAPE}, {PREP_PAIR_ITERS} "
            f"iterations: TRE {tres[device][0]:.3f} -> {tres[device][1]:.4f} ({device}), "
            f"{tres['cpu'][1]:.4f} (cpu); final parameters max |diff| {err:.3e} voxel (tol "
            f"{PREP_PAIR_TOL})")
    if worst > PREP_PAIR_TOL:
        raise SystemExit("[preprocess] the card's registration differs from the CPU's")
    shutil.rmtree(work)


MULTI_RANKS = 2  # processes sharing cuda:0 under gloo in [multi] (b)
MULTI_RING = (1, 13824, 4, 32)  # the DE128 cross attention's 24³ level: [B, N, H, D]
MULTI_TP_TILES = 2  # (c)'s bf16 chunk: a 96³×48 f32 activation is ~170 MB a tile through gloo
TP_STEP_RTOL = 1e-5  # (c)'s f32 step, split against whole: loss and grad_norm, relative
TP_LR = 0.1  # (c)'s step is SGD: Adam would turn the noise of a zero gradient into ±lr steps
TP_WEIGHT_TOL = 1e-4  # (c)'s gathered weights after the step, absolute
TP_UPDATE_RTOL = 1e-3  # (c): ||split - whole|| after the step over the whole step's ||update||
NEAR_TIE = 1e-4  # (d): voxels whose one-process top-2 logit margin is under it may flip
MULTI_TUNE_SW = (8, 15)  # (e): the two tile-chunk candidates at overlap 0.5 on the [http] case
AF_LR = 1e-2  # (f)'s adafactor steps: a LayerNorm weight (rms 1) moves by ~lr, past TP_WEIGHT_TOL


def tp_launches(plan, tiles: int, dtype, window_repeat: int, flash_repeat: int) -> tuple:
    """Kernel A's and B's launches on one model rank of ``plan`` (a
    ``TPPlan`` of the flagship) for a batch of ``tiles`` tiles, and the head
    count of each launch in forward order: a split layer's share, a
    replicated one's whole."""
    from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as fa
    from multimodal_organ_segmentation_tpu_torch.ops import window_attention as wa

    local = {lp.module: lp.local.get("num_heads") for lp in plan.layers if lp.split}
    counts = {"window_attention": dict.fromkeys(wa.ROUTES, 0),
              "flash_attention": dict.fromkeys(fa.ROUTES, 0)}
    heads = {"window_attention": [], "flash_attention": []}
    depths = FLAGSHIP["model"]["backbone"]["depths"]
    blocks = iter(f"stage{s}_block{b}" for s, d in enumerate(depths) for b in range(d))
    for _, bw, h, nw, _, w in window_shapes(tiles):
        h = local.get(f"{next(blocks)}.attn") or h
        route = wa.plan(bw, w**3, h, 16, nw or 1, dtype)["route"]
        counts["window_attention"][route] += window_repeat
        heads["window_attention"].append(h)
    for stage, b, n, h, d in flash_shapes(tiles):
        h = local.get(f"xfuse{stage}") or h
        counts["flash_attention"][fa.plan(b, n, n, h, d, dtype)["route"]] += flash_repeat
        heads["flash_attention"].append(h)
    return counts, heads


def _record_heads():
    """Wrap the models' calls of kernels A and B to record each call's head
    count; returns (the record, a function that undoes the wrapping)."""
    from multimodal_organ_segmentation_tpu_torch.models import fusion as tfusion
    from multimodal_organ_segmentation_tpu_torch.models import swin_unetr as tswin

    seen = {"window_attention": [], "flash_attention": []}
    wa, mha = tswin.window_mha, tfusion.multi_head_attention
    tswin.window_mha = lambda q, *a: seen["window_attention"].append(q.shape[2]) or wa(q, *a)
    tfusion.multi_head_attention = (
        lambda q, *a, **k: seen["flash_attention"].append(q.shape[2]) or mha(q, *a, **k))

    def undo():
        tswin.window_mha, tfusion.multi_head_attention = wa, mha

    return seen, undo


def split_against_whole(rank: int, split_cfg: dict, whole_cfg: dict, batch: list,
                        device: str = "cuda", before_split=None, after_split=None,
                        same_grads: bool = False) -> dict:
    """One f32 step (TF32 off) of the flagship trainer on ``batch``: on rank
    0 of the whole model in one process (``whole_cfg``, no mesh), then on
    every rank laid out by ``split_cfg``'s ``parallel`` block;
    ``before_split()`` / ``after_split(trainer)`` bracket the split step.
    Rank 0's record: each step's loss, grad_norm and rows, the gathered
    weights' largest error against the whole step's, the whole step's
    largest move (a check whose update moves no weight past its tolerance
    could not fail) and ||split - whole|| / ||update||.

    With ``same_grads`` the split optimiser steps on the whole step's
    gradients (sent from rank 0, each rank taking its piece), so that the
    weights hold the split optimiser alone: adafactor's first update of an
    unfactored leaf is g / sqrt(g² + eps), a sign, and a gradient element
    within rounding of zero flips its weight's move between two
    computations of it. Loss and grad_norm still hold the split forward and
    backward."""
    import torch
    import torch.distributed as dist

    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer, local_state

    def build(run, name, mesh):
        run = json.loads(json.dumps(run))
        run["experiment"]["name"] = f"multi_{name}"
        trainer = Trainer(run, device=device, mesh=mesh)
        trainer.init_state()
        return trainer

    def step(trainer, name):
        images, labels = trainer._stack_accum(batch)
        _, metrics = trainer.train_step_fn()(trainer.state, images, labels,
                                             trainer.keys.next(), rows=trainer._step_rows)
        steps[name] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "rows": int(images.shape[1])}

    def host(sd):
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out, steps, grads = {}, {}, None
    try:
        if rank == 0:
            trainer = build(whole_cfg, "one", False)
            before = host(trainer.model.state_dict())
            opt = trainer.state.optimizer
            if same_grads:
                inner = opt.step

                def keep(grad_norm=None):
                    nonlocal grads
                    grads = host({n: p.grad for n, p in trainer.model.named_parameters()})
                    inner(grad_norm=grad_norm)

                opt.step = keep
            step(trainer, "one")
            after = host(trainer.model.state_dict())
            del trainer, opt
            if device == "cuda":
                torch.cuda.empty_cache()
        if same_grads:
            box = [grads]
            dist.broadcast_object_list(box, src=0)
            grads = box[0]
        if before_split is not None:
            before_split()
        trainer = build(split_cfg, "split", None)
        if same_grads:
            opt, model = trainer.state.optimizer, trainer.model
            inner = opt.step

            def swap(grad_norm=None):
                with torch.no_grad():
                    for n, g in local_state(model, grads).items():
                        dict(model.named_parameters())[n].grad.copy_(g)
                inner(grad_norm=grad_norm)

            opt.step = swap
        step(trainer, "split")
        if after_split is not None:
            after_split(trainer)
        gathered = trainer.state.tree()["params"]  # the whole layout, gathered (a collective)
        if rank == 0:
            # weights left stale by the split step would show here
            err = moved = err2 = moved2 = 0.0
            for k, v in after.items():
                v = v.double()
                diff, delta = gathered[k].detach().cpu().double() - v, v - before[k].double()
                err, moved = max(err, float(diff.abs().max())), max(moved, float(delta.abs().max()))
                err2, moved2 = err2 + float((diff**2).sum()), moved2 + float((delta**2).sum())
            out["weights_err"], out["update_max"] = err, moved
            out["update_rel"] = (err2 / moved2) ** 0.5 if moved2 else float("inf")
        del trainer, gathered, grads
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["steps"] = steps
    return out


def multi_tp(rank: int, world: int, device: str = "cuda") -> dict:
    """[multi] (c) on one rank of a ``world``-rank group: the flagship at full
    width on a ``data 1 × model world`` mesh. A bf16 forward of a chunk of
    ``MULTI_TP_TILES`` tiles, split, and (rank 0) the whole model's forward
    of the same tiles; one f32 SGD step at micro-batch 1, split, its
    gathered weights, and (rank 0) the whole model's step; each rank's A
    and B launches and head counts against the plan's; the split layers'
    parameter bytes a rank."""
    import torch
    import torch.distributed as dist

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

    seed = FLAGSHIP["experiment"]["seed"]
    tp_mesh = {"data": 1, "model": world}
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["parallel"]["mesh"] = tp_mesh
    size = FLAGSHIP["model"]["backbone"]["img_size"]
    x = torch.from_numpy(np.random.default_rng(seed + 20).standard_normal(
        (MULTI_TP_TILES, *size, 2), np.float32)).to(device)
    out = {}
    t0 = time.perf_counter()
    seen, undo = _record_heads()
    try:
        model = build_model(cfg, device=device)  # bf16, this rank's shard
        plan = model.tp_plan
        out["split_bytes"] = sum(v.numel() * v.element_size()
                                 for k, v in model.state_dict().items() if k in plan.splits)
        out["all_bytes"] = sum(v.numel() * v.element_size() for v in model.state_dict().values())
        out["plan"] = plan.describe()
        reset_launches(window_mha, flash_attention)
        with torch.no_grad():
            split = model(x).float()
        _sync(device)
        out["fwd_launches"], out["fwd_heads"] = attention_launches(), json.loads(json.dumps(seen))
        out["fwd_expect"] = tp_launches(plan, MULTI_TP_TILES, torch.bfloat16, 1, 1)
        del model
        if rank == 0:
            whole = build_model(FLAGSHIP, device=device)
            with torch.no_grad():
                one = whole(x).float()
            del whole
            top2 = one.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 2 * MODEL_TOL_BF16
            same = split.argmax(-1) == one.argmax(-1)
            out["fwd"] = {"err": float((split - one).abs().max()), "scale": float(one.abs().max()),
                          "agree": float(same.float().mean()),
                          "agree_clear": bool(same[clear].all()),
                          "finite": bool(torch.isfinite(split).all())}
            del one
        del split
        out["fwd_s"] = time.perf_counter() - t0

        # one f32 step at micro-batch 1, SGD, TF32 off
        t1 = time.perf_counter()
        tcfg = train_config("fp32", accumulation_steps=1)
        tcfg["training"]["batch_size"] = 1
        tcfg["training"]["optimizer"] = {"name": "sgd", "lr": TP_LR, "momentum": 0.9,
                                         "weight_decay": 0.0}
        split = json.loads(json.dumps(tcfg))
        split["parallel"]["mesh"] = tp_mesh

        def launches_of(trainer):
            _sync(device)
            out["step_launches"] = attention_launches()
            out["step_heads"] = json.loads(json.dumps(seen))
            # remat runs each Swin block's forward twice; the fusions once
            out["step_expect"] = tp_launches(trainer.model.tp_plan, 1, torch.float32, 2, 1)

        def before_split():
            reset_launches(window_mha, flash_attention)
            for v in seen.values():
                v.clear()

        image, label = training_patches(1, seed)[0]
        out.update(split_against_whole(rank, split, tcfg, [{"image": image[None],
                                                            "label": label[None]}],
                                       device, before_split, launches_of))
        out["step_s"] = time.perf_counter() - t1
    finally:
        undo()
    dist.barrier()
    return out


def multi_serve(rank: int, http: dict, device: str = "cuda") -> dict:
    """[multi] (d) on one rank of a data-parallel group: the flagship
    service from the [http] phase's checkpoint, rank 0 serving one request
    of the [http] case over HTTP while the other ranks follow, then its
    stop; rank 0 compares the mask with the [http] phase's one-process mask
    outside near-ties of the one-process logits."""
    import threading

    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.postprocess import postprocess_from_config
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import sliding_window_inference
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.serving.server import InferenceService, make_server
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
    from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti

    t0 = time.perf_counter()
    cfg = json.loads(json.dumps(http["cfg"]))
    service = InferenceService(ConfigNode(cfg), http["ckpt"], device=device)
    reset_launches(window_mha, flash_attention)
    out = {"mesh": dict(service.mesh_shape), "build_s": time.perf_counter() - t0}
    if rank == 0:
        httpd = make_server(service, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            out["segment"] = _http(base, "/v1/segment", {
                "inputs": http["inputs"], "case_id": "multi",
                "output_dir": str(Path(http["work"]) / "served_multi")})
            out["stats"] = _http(base, "/v1/stats")[1]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
            service.close()
        out["launches"] = attention_launches()
        out["chunks"] = service.runner.grid(tuple(http["volume"]))[0].shape[0]
        served = Path(http["work"]) / "served_multi" / "multi_pred.nii.gz"
        mask = load_nifti(served).astype(np.uint8)
        ref = np.load(http["mask"])
        # the one-process logits, on this rank alone (no collective)
        sw = cfg["inference"]["sliding_window"]
        vol = torch.from_numpy(np.stack([load_nifti(http["inputs"][m])
                                         for m in cfg["data"]["modalities"]], -1)).to(device)
        with torch.no_grad():
            logits = sliding_window_inference(vol, service.runner.predict_fn.__self__.model,
                                              tuple(sw["roi_size"]), cfg["model"]["out_channels"],
                                              sw["overlap"], cfg["inference"]["batch_size"],
                                              sw["mode"])
            top2 = logits.topk(2, dim=-1).values
            near = ((top2[..., 0] - top2[..., 1]) < NEAR_TIE).cpu().numpy()
            own = postprocess_from_config(logits.argmax(-1).cpu().numpy().astype(np.uint8),
                                          ConfigNode(cfg))
        differ = mask != ref
        out["differ"] = int(differ.sum())
        out["differ_clear"] = int((differ & ~near).sum())
        out["near"] = int(near.sum())
        out["differ_own"] = int((mask != own).sum())
        del vol, logits
    else:
        out["passes"] = service.follow()
        out["launches"] = attention_launches()
    out["wall_s"] = time.perf_counter() - t0
    del service
    if device == "cuda":
        torch.cuda.empty_cache()
    return out



def sub_counts(after: dict, before: dict) -> dict:
    """``after - before``, route by route, of two launch-count snapshots."""
    return {name: {route: n - before[name][route] for route, n in counts.items()}
            for name, counts in after.items()}


def multi_tune(rank: int, http: dict, device: str = "cuda") -> dict:
    """[multi] (e) on one rank of the data-parallel group: ``--mode tune``
    through ``cli.main`` (which joins the group) on the flagship at the
    [http] case's shape over ``MULTI_TUNE_SW`` at overlap 0.5, one timed run
    each. The rank's report as ``tune_serving`` returned it, its
    ``write_profile`` calls, and each candidate's A/B launches on this rank
    beside the tile grid's plan (this rank's chunks of every pass), and the
    ranks' votes (``parallel.mesh.Agreement``): their count and host time."""
    from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
    from multimodal_organ_segmentation_tpu_torch.parallel import mesh as tmesh
    from multimodal_organ_segmentation_tpu_torch.serving import tuner

    reports, writes, got, expect, votes = [], [], {}, {}, [0, 0.0]
    vote = tmesh.Agreement._vote

    def timed_vote(self, failed, values):
        t0 = time.perf_counter()
        out = vote(self, failed, values)
        votes[0], votes[1] = votes[0] + 1, votes[1] + time.perf_counter() - t0
        return out

    tmesh.Agreement._vote = timed_vote
    tune_serving, write_profile = tuner.tune_serving, tuner.write_profile
    tuner.tune_serving = lambda *a, **k: reports.append(tune_serving(*a, **k)) or reports[-1]
    tuner.write_profile = lambda *a, **k: writes.append(str(a[1])) or write_profile(*a, **k)
    call = tsw.SlidingWindowRunner.__call__

    def counted(self, volume, params=None):
        before = attention_launches()
        logits = call(self, volume, params)
        _sync(device)
        key = f"{self.overlap}/{self.sw_batch_size}"
        got[key] = add_counts(got.get(key, {}), sub_counts(attention_launches(), before))
        chunks = self.grid(tuple(volume.shape[:3]))[0].shape[0] // self.mesh.shape["data"]
        expect[key] = add_counts(expect.get(key, {}),
                                 predicted_launches(self.sw_batch_size, chunks, chunks))
        return logits

    tsw.SlidingWindowRunner.__call__ = counted
    profile = Path(http["work"]) / "multi_tuned.yaml"
    try:
        wall = _cli(["--mode", "tune", "--config", http["cfg_path"], "--output", str(profile),
                     "--set", f"tune.volume_shape={list(http['volume'])}",
                     "--set", f"tune.sw_batches={list(MULTI_TUNE_SW)}",
                     "--set", "tune.overlaps=[0.5]", "--set", "tune.repeats=1"], device)
    finally:
        tuner.tune_serving, tuner.write_profile = tune_serving, write_profile
        tsw.SlidingWindowRunner.__call__ = call
        tmesh.Agreement._vote = vote
    return {"reports": reports, "writes": writes, "profile": str(profile), "launches": got,
            "expect": expect, "wall_s": wall, "votes": votes[0], "vote_s": votes[1]}


def multi_adafactor(rank: int, world: int, device: str = "cuda") -> dict:
    """[multi] (f) on one rank: one f32 adafactor step (``AF_LR``) of the
    flagship split two ways against the whole model's one-rank step: ZeRO-1
    on ``data world`` at micro-batch 2 split 1 + 1, as (b) runs its step,
    and tensor parallelism on ``data 1 × model world`` at micro-batch 1, as
    (c) runs its step; the split optimiser steps on the whole step's
    gradients (``split_against_whole``'s ``same_grads``)."""
    import types

    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

    t0 = time.perf_counter()
    patches = training_patches(2, FLAGSHIP["experiment"]["seed"])
    out = {}
    for layout, micro, parallel in (("zero1", 2, {"zero1": True}),
                                    ("tp", 1, {"mesh": {"data": 1, "model": world}})):
        whole = train_config("fp32", accumulation_steps=1)
        whole["training"]["batch_size"] = micro
        whole["training"]["optimizer"] = {"name": "adafactor", "lr": AF_LR, "weight_decay": 0.0}
        split = json.loads(json.dumps(whole))
        split["parallel"].update(parallel)
        batch = [{"image": np.stack([p[0] for p in patches[:micro]]),
                  "label": np.stack([p[1] for p in patches[:micro]])}]
        seen = {}

        def launches_of(trainer):
            # the split step's A and B launches on this rank: one row, remat
            _sync(device)
            plan = getattr(trainer.model, "tp_plan", None) or types.SimpleNamespace(layers=[])
            seen["launches"] = attention_launches()
            seen["expect"] = tp_launches(plan, 1, torch.float32, 2, 1)[0]

        out[layout] = split_against_whole(rank, split, whole, batch, device,
                                          lambda: reset_launches(window_mha, flash_attention),
                                          launches_of, same_grads=True)
        out[layout].update(seen)
    out["wall_s"] = time.perf_counter() - t0
    return out


def multi_ring_model(rank: int, world: int, device: str = "cuda") -> dict:
    """[multi] (g) on one rank: the 128³ DualEncoder (f32) built with
    ``sequence_axis: model`` on ``data 1 × model world``; its widest
    attending level, which the ring's doubled token budget opened (32³ =
    32768 tokens, 128 channels, 4 heads), forward and backward through the
    fusion module with the ring over the model group (every rank holding the
    batch); rank 0 holds the output and the gradients of both inputs and of
    the q projection against the same module with dense attention (chunked
    over the queries, each chunk recomputed in the backward), its largest
    error over each reference's largest magnitude."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from multimodal_organ_segmentation_tpu_torch.models import fusion as tfusion
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.parallel import ring_attention as ra
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import same_input

    t0 = time.perf_counter()
    cfg = model_config(DE128)
    cfg["hardware"]["mixed_precision"] = "fp32"
    cfg["parallel"] = {"mesh": {"data": 1, "model": world}, "sequence_axis": "model"}
    model = build_model(cfg, device=device, train=True)
    level = min(lv for lv in range(5) if hasattr(model, f"fusion_xattn{lv}"))
    fusion = getattr(model, f"fusion_xattn{level}").eval()  # no dropout draw
    grid = cfg["model"]["backbone"]["img_size"][0] >> level
    c = cfg["model"]["backbone"]["features"][level]
    g = torch.Generator(device=device).manual_seed(5)
    qf, kvf, do = (torch.randn((1, grid, grid, grid, c), generator=g, device=device)
                   for _ in range(3))
    out = {"level": level, "tokens": grid**3, "channels": c, "heads": fusion.num_heads,
           "axis": fusion.sequence_axis}

    def run(module):
        q, kv = qf.clone().requires_grad_(), kvf.clone().requires_grad_()
        module.zero_grad(set_to_none=True)
        y = module(q, kv)
        (y * do).sum().backward()
        return y.detach(), q.grad, kv.grad, module.q_proj.weight.grad

    rings = []
    ring = ra.ring_attention
    ra.ring_attention = lambda *a, **k: rings.append(a[4]) or ring(*a, **k)
    try:
        with same_input():
            got = run(fusion)
        _sync(device)
    finally:
        ra.ring_attention = ring
    out["rings"], out["ring_s"] = rings, time.perf_counter() - t0
    if rank == 0:
        def dense(q, k, v, **_):
            scale = q.shape[-1] ** -0.5

            def chunk(qc):
                s = torch.einsum("bnhd,bmhd->bhnm", qc, k) * scale
                return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v)

            return torch.cat([checkpoint(chunk, q[:, i:i + 4096], use_reentrant=False)
                              for i in range(0, q.shape[1], 4096)], 1)

        ref_module = tfusion.CrossAttentionFusion(c, fusion.num_heads).to(device).eval()
        ref_module.load_state_dict(fusion.state_dict())
        mha = tfusion.multi_head_attention
        tfusion.multi_head_attention = dense
        try:
            want = run(ref_module)
        finally:
            tfusion.multi_head_attention = mha
        out["errs"] = {name: float((a - b).abs().max()) / float(b.abs().max())
                       for name, a, b in zip(("out", "d_query", "d_kv", "d_q_proj"), got, want)}
        out["scales"] = {name: float(b.abs().max())
                         for name, b in zip(("out", "d_query", "d_kv", "d_q_proj"), want)}
        del ref_module, want
    del model, fusion, got
    if device == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _multi_volume():
    """The [multi] phase's 192×192×256 CT+PET volume, from the seed."""
    import torch

    rng = np.random.default_rng(FLAGSHIP["experiment"]["seed"] + 10)
    return torch.from_numpy(rng.standard_normal((*VOLUME, 2), np.float32)).cuda()


def _multi_sw():
    sw_cfg = FLAGSHIP["inference"]["sliding_window"]
    return (tuple(sw_cfg["roi_size"]), FLAGSHIP["model"]["out_channels"], sw_cfg["overlap"],
            FLAGSHIP["inference"]["batch_size"])


def multi_rank(rank: int, world: int, rendezvous: str, ref_path: str, out_path: str,
               http: dict) -> None:
    """One of the [multi] phase's gloo ranks on cuda:0: the tile-sharded
    flagship volume, one data-parallel f32 train step of the flagship (the
    rank's rows of a micro-batch of 2) and the one-rank step on the whole
    micro-batch (rank 0), the ring at a DE128 level; then (c) tensor
    parallelism (``multi_tp``), (d) the multi-rank service
    (``multi_serve``), (e) ``--mode tune`` across the ranks
    (``multi_tune``), (f) adafactor under ZeRO-1 and tensor parallelism
    (``multi_adafactor``) and (g) the DE128's ring over the model axis
    (``multi_ring_model``); results to ``out_path``."""
    import torch
    import torch.distributed as dist

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        sharded_sliding_window_inference,
    )
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import all_gather_cat, make_mesh
    from multimodal_organ_segmentation_tpu_torch.parallel.ring_attention import ring_attention
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    torch.cuda.set_device(0)
    import datetime

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    out = {}
    try:
        mesh = make_mesh()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(FLAGSHIP)
        roi, classes, overlap, sw = _multi_sw()
        with torch.no_grad():
            logits = sharded_sliding_window_inference(_multi_volume(), model, roi, classes, mesh,
                                                      overlap=overlap, sw_batch_size=sw)
        torch.cuda.synchronize()
        out["volume_s"] = time.perf_counter() - t0
        if rank == 0:
            ref = torch.load(ref_path, map_location="cuda")
            out["volume_err"] = float((logits - ref).abs().max())
            out["volume_scale"] = float(ref.abs().max())
        del model, logits
        torch.cuda.empty_cache()

        # one data-parallel f32 step: this rank's row of a micro-batch of 2
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        patches = training_patches(2, FLAGSHIP["experiment"]["seed"])
        batch = [{"image": np.stack([p[0] for p in patches]),
                  "label": np.stack([p[1] for p in patches])}]
        t0 = time.perf_counter()
        for name, mesh_arg in (("dp", None), ("one", False)):
            if name == "one" and rank != 0:
                break
            trainer = Trainer(train_config("fp32", accumulation_steps=1), mesh=mesh_arg)
            trainer.init_state()
            images, labels = trainer._stack_accum(batch)
            _, metrics = trainer.train_step_fn()(trainer.state, images, labels,
                                                 trainer.keys.next(), rows=trainer._step_rows)
            out[name] = {"rows": int(images.shape[1]), "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"])}
            del trainer, images, labels
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        # the ring at the DE128 level (f32), forward and backward, against
        # dense attention computed on one rank
        b, n, h, d = MULTI_RING
        g = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, do = (torch.randn(MULTI_RING, generator=g, device="cuda") for _ in range(4))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        t0 = time.perf_counter()
        m = n // world
        sl = slice(rank * m, (rank + 1) * m)
        ring = all_gather_cat(ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh), 1, mesh)
        (ring * do).sum().div(world).backward()
        grads = [t.grad.clone() for t in (q, k, v)]
        for t in grads:
            dist.all_reduce(t)
        torch.cuda.synchronize()
        out["ring_s"] = time.perf_counter() - t0
        if rank == 0:
            for t in (q, k, v):
                t.grad = None
            dense = torch.cat([torch.softmax(
                torch.einsum("bnd,bmd->bnm", q[:, i:i + 1728, hh], k[:, :, hh]) * d ** -0.5, -1)
                @ v[:, :, hh] for hh in range(h) for i in range(0, n, 1728)], 1)
            dense = dense.reshape(b, h, n, d).permute(0, 2, 1, 3)
            (dense * do).sum().backward()
            out["ring_err"] = float((ring - dense).detach().abs().max())
            out["ring_grad_err"] = max(float((gr - t.grad).abs().max())
                                       for gr, t in zip(grads, (q, k, v)))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del q, k, v, do, ring, grads
        torch.cuda.empty_cache()
        dist.barrier()

        out["tp"] = multi_tp(rank, world)
        out["serve"] = multi_serve(rank, http)
        dist.barrier()
        out["tune"] = multi_tune(rank, http)
        out["adafactor"] = multi_adafactor(rank, world)
        out["ring_model"] = multi_ring_model(rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        torch.save(out, out_path)


def phase_multi(http: dict) -> dict:
    """Multi-device on one card: (a) one NCCL rank on cuda:0 runs
    ``sharded_sliding_window_inference`` and the runner with a mesh over the
    flagship volume at full width, each equal bit for bit to the
    one-device runner's logits, kernels A and B launched as the tile grid
    plans; (b) ``MULTI_RANKS`` processes share cuda:0 under gloo (CUDA
    collectives gloo cannot carry stage through the host): the tile-sharded
    volume within bf16 ``TOL`` of (a), one data-parallel f32 train step of
    the flagship (micro-batch 2 split 1 + 1) within ``STEP_RTOL`` of the
    one-rank step, the ring at a DE128 level (f32, forward and backward)
    against dense attention within ``TOL``; in the same two gloo ranks, (c)
    tensor parallelism on a ``data 1 × model 2`` mesh (``multi_tp``: the bf16
    forward of ``MULTI_TP_TILES`` tiles against the whole model's at the bf16
    logit check, one f32 SGD step within ``TP_STEP_RTOL`` of the whole
    model's and its gathered weights within ``TP_WEIGHT_TOL`` and
    ``TP_UPDATE_RTOL`` of the whole model's update, A and B launched on each
    rank as the plan says, with its head counts) and (d)
    the multi-rank service on a ``data 2`` mesh (``multi_serve``: one
    request of the [http] case, its mask equal to [http]'s outside
    near-ties, the follower stopped); (e) ``--mode tune`` on both ranks
    (``multi_tune``: one table and pick on both, the profile written once,
    each candidate's launches a rank to the plan); (f) one f32 adafactor
    step under ZeRO-1 and under tensor parallelism (``multi_adafactor``)
    against the one-rank step, at (b)'s and (c)'s tolerances; (g) the
    DE128's ring level with ``sequence_axis: model`` (``multi_ring_model``)
    against dense attention within ``TOL``; then wall times and peak memory
    per rank beside the card's name and power limit. ``http`` holds the
    [http] phase's config and its file, checkpoint, case, mask file and work
    directory. Returns the launches of (a) and (c) to (f) together."""
    import multiprocessing

    import torch
    import torch.distributed as dist

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
        SlidingWindowRunner,
        sharded_sliding_window_inference,
        tile_count,
    )
    from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_multi_", dir="outputs")).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    try:
        # (a) one NCCL rank
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{work / 'nccl'}", rank=0,
                                world_size=1)
        try:
            torch.cuda.reset_peak_memory_stats()
            model = build_model(FLAGSHIP)
            roi, classes, overlap, sw = _multi_sw()
            vol = _multi_volume()
            predict = lambda prm, p: model(p)  # noqa: E731
            with torch.no_grad():
                ref = SlidingWindowRunner(predict, roi, classes, overlap, sw)(vol)
                chunks = math.ceil(tile_count(VOLUME, roi, overlap) / sw)
                expect = predicted_launches(sw, 2 * chunks, 2 * chunks)
                mesh = make_mesh()
                reset_launches(window_mha, flash_attention)
                sharded = sharded_sliding_window_inference(vol, model, roi, classes, mesh,
                                                           overlap=overlap, sw_batch_size=sw)
                runner = SlidingWindowRunner(predict, roi, classes, overlap, sw, mesh=mesh)(vol)
                torch.cuda.synchronize()
            launches = attention_launches()
            same = torch.equal(sharded, ref) and torch.equal(runner, ref)
            ok = same and bool(torch.isfinite(ref).all()) and ref.shape == (*VOLUME, classes)
            torch.save(ref, work / "ref.pt")
            peak_a = torch.cuda.max_memory_allocated() / 2**30
            del model, vol, ref, sharded, runner
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        wall_a = time.perf_counter() - t0
        log(f"[multi] (a) one NCCL rank on cuda:0, {VOLUME}x2, {chunks} chunks of {sw}: "
            f"sharded_sliding_window_inference and the runner with a mesh equal to the "
            f"one-device runner bit for bit: {same}; wall {wall_a:.1f} s (model build, 3 "
            f"volumes), max_memory_allocated {peak_a:.2f} GiB")
        log(f"[multi] (a) kernels {json.dumps(launches)} expected {json.dumps(expect)}")
        if not ok:
            raise SystemExit("[multi] the sharded sliding window at one rank differs from the "
                             "one-device runner")
        if launches != expect:
            raise SystemExit("[multi] the sharded path's kernel launches differ from the plan")

        # (b) MULTI_RANKS processes on cuda:0 under gloo
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=multi_rank, args=(r, MULTI_RANKS, str(work / "gloo"),
                                                      str(work / "ref.pt"), str(work / f"r{r}.pt"),
                                                      http))
                 for r in range(MULTI_RANKS)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(timeout=600)
        wall_b = time.perf_counter() - t0
        codes = [proc.exitcode for proc in procs]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        if codes != [0] * MULTI_RANKS:
            raise SystemExit(f"[multi] (b) a gloo rank failed: exit codes {codes} (a collective "
                             "gloo cannot carry on CUDA tensors raises there)")
        ranks = [torch.load(work / f"r{r}.pt") for r in range(MULTI_RANKS)]
        r0 = ranks[0]
        rel = max(abs(r0["dp"]["loss"] - r0["one"]["loss"]) / abs(r0["one"]["loss"]),
                  abs(r0["dp"]["grad_norm"] - r0["one"]["grad_norm"]) / abs(r0["one"]["grad_norm"]))
        log(f"[multi] (b) {MULTI_RANKS} gloo ranks sharing cuda:0: wall {wall_b:.1f} s (process "
            f"start included); per rank: volume s {[round(r['volume_s'], 2) for r in ranks]}, "
            f"train s {[round(r['train_s'], 2) for r in ranks]}, ring s "
            f"{[round(r['ring_s'], 2) for r in ranks]}, max_memory_allocated GiB "
            f"{[round(r['peak_gib'], 2) for r in ranks]}")
        log(f"[multi] (b) tile-sharded volume against (a): max |diff| {r0['volume_err']:.3e} "
            f"(logits up to {r0['volume_scale']:.2f}; tol {TOL['bfloat16']})")
        log(f"[multi] (b) DP f32 step, rows {[r['dp']['rows'] for r in ranks]} of 2: loss "
            f"{r0['dp']['loss']:.6f} grad_norm {r0['dp']['grad_norm']:.6f}; one rank, rows "
            f"{r0['one']['rows']}: loss {r0['one']['loss']:.6f} grad_norm "
            f"{r0['one']['grad_norm']:.6f}; max relative difference {rel:.2e} (tol {STEP_RTOL:.0e})")
        log(f"[multi] (b) ring {list(MULTI_RING)} f32 over {MULTI_RANKS} ranks against dense "
            f"attention: out {r0['ring_err']:.3e}, q/k/v gradients {r0['ring_grad_err']:.3e} "
            f"(tol {TOL['float32']})")
        if not (r0["volume_err"] <= TOL["bfloat16"] and rel <= STEP_RTOL
                and [r["dp"]["rows"] for r in ranks] == [1] * MULTI_RANKS
                and r0["ring_err"] <= TOL["float32"] and r0["ring_grad_err"] <= TOL["float32"]):
            raise SystemExit("[multi] (b) a check of the gloo ranks failed")
        ok_c = check_multi_tp([r["tp"] for r in ranks])
        ok_d = check_multi_serve([r["serve"] for r in ranks])
        tp_s = max(r["tp"]["fwd_s"] + r["tp"]["step_s"] for r in ranks)
        serve_s = max(r["serve"]["wall_s"] for r in ranks)
        log(f"[multi] (c) time {tp_s:.1f} s (both ranks; forward, whole forward, split and whole "
            f"f32 steps)")
        log(f"[multi] (d) time {serve_s:.1f} s (service builds, one request, the one-process "
            f"margins)")
        ok_e = check_multi_tune([r["tune"] for r in ranks])
        ok_f = check_multi_adafactor([r["adafactor"] for r in ranks])
        ok_g = check_multi_ring_model([r["ring_model"] for r in ranks])
        efg_s = max(r["tune"]["wall_s"] + r["adafactor"]["wall_s"] + r["ring_model"]["wall_s"]
                    for r in ranks)
        log(f"[multi] (e) to (g) time {efg_s:.1f} s (slowest rank; tune "
            f"{max(r['tune']['wall_s'] for r in ranks):.1f} s, adafactor "
            f"{max(r['adafactor']['wall_s'] for r in ranks):.1f} s, ring model "
            f"{max(r['ring_model']['wall_s'] for r in ranks):.1f} s)")
        log(f"[multi] {smi}; (a) {wall_a:.1f} s, (b) to (g) {wall_b:.1f} s")
        if not ok_c:
            raise SystemExit("[multi] (c) a tensor-parallel check failed")
        if not ok_d:
            raise SystemExit("[multi] (d) a multi-rank serving check failed")
        if not ok_e:
            raise SystemExit("[multi] (e) a multi-rank tuning check failed")
        if not ok_f:
            raise SystemExit("[multi] (f) an adafactor check failed")
        if not ok_g:
            raise SystemExit("[multi] (g) the DE128's ring over the model axis failed")
        launches = add_counts(launches, *[r["tp"]["fwd_launches"] for r in ranks],
                              *[r["tp"]["step_launches"] for r in ranks],
                              *[r["serve"]["launches"] for r in ranks],
                              *[c for r in ranks for c in r["tune"]["launches"].values()],
                              *[r["adafactor"][k]["launches"] for r in ranks for k in ("zero1", "tp")])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def check_multi_tp(ranks: list, device: str = "cuda") -> bool:
    """Log and hold (c): the split forward within the bf16 logit check of the
    whole model's, labels equal where the margin is clear; the split f32
    step's loss and grad_norm within ``TP_STEP_RTOL`` of the whole model's,
    the gathered weights within ``TP_WEIGHT_TOL`` of its and within
    ``TP_UPDATE_RTOL`` of its update, which moves a weight by at least ten
    times ``TP_WEIGHT_TOL``; each rank's launches and
    head counts as its plan says (A and B all ``mma`` in bf16)."""
    r0 = ranks[0]
    f, steps = r0["fwd"], r0["steps"]
    rel = max(abs(steps["split"][k] - steps["one"][k]) / abs(steps["one"][k])
              for k in ("loss", "grad_norm"))
    log(f"[multi] (c) tensor parallelism, mesh data 1 x model {len(ranks)}, flagship fs 48 at "
        f"full width; plan: " + "; ".join(r0["plan"]))
    log(f"[multi] (c) split parameters a rank: {r0['split_bytes'] / 2**20:.1f} MiB of "
        f"{r0['all_bytes'] / 2**20:.1f} MiB bf16 (each split layer's share 1/{len(ranks)})")
    log(f"[multi] (c) bf16 forward of {MULTI_TP_TILES} tiles, split against whole: max |diff| "
        f"{f['err']:.3e} (tol {MODEL_TOL_BF16}; largest |logit| {f['scale']:.2f}), label "
        f"agreement {f['agree']:.6f}, all labels agree where the top-2 margin > "
        f"{2 * MODEL_TOL_BF16}: {f['agree_clear']}")
    log(f"[multi] (c) f32 SGD step, micro-batch 1: split loss {steps['split']['loss']:.7f} "
        f"grad_norm {steps['split']['grad_norm']:.7f}; whole loss {steps['one']['loss']:.7f} "
        f"grad_norm {steps['one']['grad_norm']:.7f}; max relative difference {rel:.2e} (tol "
        f"{TP_STEP_RTOL:.0e}); gathered weights max |diff| {r0['weights_err']:.3e} (tol "
        f"{TP_WEIGHT_TOL:.0e}) while the whole step moved a weight by up to "
        f"{r0['update_max']:.3e} (at least {10 * TP_WEIGHT_TOL:.0e}); ||split - whole|| / "
        f"||update|| {r0['update_rel']:.3e} (tol {TP_UPDATE_RTOL:.0e})")
    ok = (f["finite"] and f["err"] <= MODEL_TOL_BF16 and f["agree_clear"] and rel <= TP_STEP_RTOL
          and r0["weights_err"] <= TP_WEIGHT_TOL and r0["update_max"] >= 10 * TP_WEIGHT_TOL
          and r0["update_rel"] <= TP_UPDATE_RTOL)
    for i, r in enumerate(ranks):
        for what, launches, expect, heads, repeat in (
                ("bf16 forward", r["fwd_launches"], r["fwd_expect"], r["fwd_heads"], 1),
                ("f32 step", r["step_launches"], r["step_expect"], r["step_heads"], 2)):
            want_counts, want_heads = expect
            same_heads = (sorted(heads["window_attention"])
                          == sorted(want_heads["window_attention"] * repeat)
                          and heads["flash_attention"] == want_heads["flash_attention"])
            log(f"[multi] (c) rank {i} {what}: kernels {json.dumps(launches)} expected "
                f"{json.dumps(want_counts)}; heads a launch A {heads['window_attention']} B "
                f"{heads['flash_attention']}, planned A {want_heads['window_attention']} B "
                f"{want_heads['flash_attention']}")
            if device == "cuda":
                ok = ok and launches == want_counts
            ok = ok and same_heads
    return ok


def check_multi_serve(ranks: list, device: str = "cuda") -> bool:
    """Log and hold (d): one 200 answer, the mesh in the stats, the mask equal
    to [http]'s outside near-ties, the follower stopped after one pass, and
    each rank's launches half of the request's chunks."""
    r0 = ranks[0]
    code, res = r0["segment"]
    stats = r0["stats"]
    log(f"[multi] (d) multi-rank service, mesh {r0['mesh']}: /v1/segment {code} load_s "
        f"{res.get('load_s')} device_s {res.get('device_s')} total_s {res.get('total_s')}; "
        f"/v1/stats requests {stats.get('requests')} mesh {stats.get('mesh')}; follower passes "
        f"{[r.get('passes') for r in ranks[1:]]}")
    log(f"[multi] (d) served mask against the [http] one-process mask: {r0['differ']} voxels "
        f"differ, {r0['differ_clear']} of them where the one-process top-2 margin >= "
        f"{NEAR_TIE:.0e}; near-tie voxels (margin < {NEAR_TIE:.0e}): {r0['near']}; against rank 0's own "
        f"one-process mask: {r0['differ_own']} voxels differ")
    per_rank = r0["chunks"] // len(ranks)
    expect = predicted_launches(FLAGSHIP["inference"]["batch_size"], per_rank, per_rank)
    for i, r in enumerate(ranks):
        log(f"[multi] (d) rank {i} kernels {json.dumps(r['launches'])} expected "
            f"{json.dumps(expect)} ({per_rank} of {r0['chunks']} chunks)")
    ok = (code == 200 and stats.get("requests") == 1 and stats.get("mesh") == r0["mesh"]
          and r0["differ_clear"] == 0 and all(r.get("passes") == 1 for r in ranks[1:]))
    if device == "cuda":
        ok = ok and all(r["launches"] == expect for r in ranks)
    return ok


def check_multi_tune(ranks: list, device: str = "cuda") -> bool:
    """Log and hold (e): one report on every rank (the same table and
    pick), no candidate failed, rank 0 alone wrote the profile, every rank
    voted as often, and each candidate's launches on each rank equal to its
    chunks' plan."""
    r0 = ranks[0]
    report = r0["reports"][0] if len(r0["reports"]) == 1 else {"results": [], "best": None}
    for r in report["results"]:
        log(f"[multi] (e) tune over {len(ranks)} ranks: overlap {r['overlap']} sw_batch "
            f"{r['sw_batch']}: " + (f"{r['vol_per_min']} volumes/min, {r['seconds_per_volume']} s "
                                     f"a volume (slowest rank; first run {r['compile_s']} s)"
                                     if "vol_per_min" in r else f"FAILED {r['error']}"))
    best = report["best"] or {}
    log(f"[multi] (e) pick overlap {best.get('overlap')} sw_batch {best.get('sw_batch')} on every "
        f"rank: {all(r['reports'] == r0['reports'] for r in ranks)}; profile writes by rank "
        f"{[len(r['writes']) for r in ranks]}; wall {[round(r['wall_s'], 1) for r in ranks]} s")
    log(f"[multi] (e) votes by rank {[r['votes'] for r in ranks]} in "
        f"{[round(r['vote_s'] * 1e3, 3) for r in ranks]} ms of host time "
        f"({[round(r['vote_s'] / max(r['votes'], 1) * 1e6, 1) for r in ranks]} us a vote)")
    ok = (len(r0["reports"]) == 1 and all(r["reports"] == r0["reports"] for r in ranks)
          and len(report["results"]) == len(MULTI_TUNE_SW)
          and all("vol_per_min" in r for r in report["results"]) and report["best"] is not None
          and [r["writes"] for r in ranks] == [[r0["profile"]]] + [[]] * (len(ranks) - 1)
          and Path(r0["profile"]).exists() and len({r["votes"] for r in ranks}) == 1)
    for i, r in enumerate(ranks):
        for key in sorted(r["expect"]):
            log(f"[multi] (e) rank {i} candidate {key}: kernels {json.dumps(r['launches'][key])} "
                f"expected {json.dumps(r['expect'][key])}")
        if device == "cuda":
            ok = ok and r["launches"] == r["expect"] and len(r["expect"]) == len(MULTI_TUNE_SW)
    return ok


def check_multi_adafactor(ranks: list, device: str = "cuda") -> bool:
    """Log and hold (f): each layout's split step within ``STEP_RTOL`` (ZeRO-1)
    or ``TP_STEP_RTOL`` (tensor parallelism) of the one-rank step in loss and
    grad_norm, the gathered weights within ``TP_WEIGHT_TOL`` and
    ``TP_UPDATE_RTOL`` of its update, which moves a weight by at least ten
    times ``TP_WEIGHT_TOL``; each rank's A and B launches in the split step
    as the plan says (``f32``, remat: A twice a block)."""
    ok = True
    for layout, rtol, what in (("zero1", STEP_RTOL, f"ZeRO-1 on data {len(ranks)}"),
                               ("tp", TP_STEP_RTOL, f"data 1 x model {len(ranks)}")):
        r0 = ranks[0][layout]
        steps = r0["steps"]
        rel = max(abs(steps["split"][k] - steps["one"][k]) / abs(steps["one"][k])
                  for k in ("loss", "grad_norm"))
        log(f"[multi] (f) adafactor f32 step, {what}, rows {[r[layout]['steps']['split']['rows'] for r in ranks]}"
            f" of {steps['one']['rows']}: split loss {steps['split']['loss']:.7f} grad_norm "
            f"{steps['split']['grad_norm']:.7f}; one rank loss {steps['one']['loss']:.7f} "
            f"grad_norm {steps['one']['grad_norm']:.7f}; max relative difference {rel:.2e} (tol "
            f"{rtol:.0e}); gathered weights max |diff| {r0['weights_err']:.3e} (tol "
            f"{TP_WEIGHT_TOL:.0e}) while the one-rank step moved a weight by up to "
            f"{r0['update_max']:.3e} (at least {10 * TP_WEIGHT_TOL:.0e}); ||split - whole|| / "
            f"||update|| {r0['update_rel']:.3e} (tol {TP_UPDATE_RTOL:.0e})")
        ok = (ok and rel <= rtol and r0["weights_err"] <= TP_WEIGHT_TOL
              and r0["update_max"] >= 10 * TP_WEIGHT_TOL and r0["update_rel"] <= TP_UPDATE_RTOL)
        for i, r in enumerate(ranks):
            log(f"[multi] (f) {what} rank {i} split step: kernels {json.dumps(r[layout]['launches'])} "
                f"expected {json.dumps(r[layout]['expect'])}")
            if device == "cuda":
                ok = ok and r[layout]["launches"] == r[layout]["expect"]
    return ok


def check_multi_ring_model(ranks: list) -> bool:
    """Log and hold (g): the ring ran over the model axis on every rank, at
    the level the doubled budget opened, and its output and gradients are
    within ``TOL`` of dense attention's (relative to the largest
    magnitude)."""
    r0 = ranks[0]
    log(f"[multi] (g) DE128 f32, sequence_axis model on data 1 x model {len(ranks)}: level "
        f"{r0['level']} ({r0['tokens']} tokens, {r0['channels']} channels, {r0['heads']} heads) "
        f"rings {[r['rings'] for r in ranks]}; against dense attention, max |diff| / max |ref|: "
        + ", ".join(f"{k} {v:.3e} (ref up to {r0['scales'][k]:.3e})" for k, v in r0["errs"].items())
        + f" (tol {TOL['float32']}); wall {[round(r['wall_s'], 1) for r in ranks]} s")
    return (all(r["rings"] == ["model"] and r["axis"] == "model" for r in ranks)
            and all(v <= TOL["float32"] for v in r0["errs"].values()))


def phase_models() -> dict:
    """The other model families on the card: the 128³ DualEncoder tile check,
    serving every configuration of ``MODEL_KEYS``, the DualEncoder's training and its
    CLI inference. Returns kernel B's launches over all of them."""
    import torch

    cfg = model_config(DE128)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, *cfg["model"]["backbone"]["img_size"], 2), np.float32)).cuda()
    check_model(DE128, cfg, x)
    del x
    rng = np.random.default_rng(cfg["experiment"]["seed"])
    total = {}
    runs = [models_serve(key, model_config(key), rng) for key in MODEL_KEYS]
    launches, trainer = models_train(rng)
    runs.append(launches)
    runs.append(models_cli(trainer, rng))
    del trainer
    torch.cuda.empty_cache()
    for run in runs:
        for route, n in run.items():
            total[route] = total.get(route, 0) + n
    return {"flash_attention": total}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    summary = phase_kernels(flush)
    del flush
    torch.cuda.empty_cache()
    phase_model()
    torch.cuda.empty_cache()
    profile = "--profile" in argv
    by_path = {}
    by_path["serve"], serve_ms = phase_serve(profile)
    torch.cuda.empty_cache()
    by_path["conv"] = phase_conv()
    torch.cuda.empty_cache()
    by_path["train"] = phase_train(profile)
    torch.cuda.empty_cache()
    by_path["cli"], analysis_case = phase_cli(serve_ms)
    torch.cuda.empty_cache()
    by_path["models"] = phase_models()
    torch.cuda.empty_cache()
    by_path["http"], cfg, cfg_path, inputs, served_mask, work = phase_http()
    torch.cuda.empty_cache()
    by_path["tune"] = phase_tune(cfg_path, work)
    torch.cuda.empty_cache()
    by_path["export"] = phase_export(cfg, cfg_path, inputs, served_mask, work)
    # [multi] (d) serves the [http] checkpoint and case and compares its mask
    np.save(work / "http_mask.npy", served_mask)
    http = {"cfg": cfg, "cfg_path": str(cfg_path), "ckpt": str(work / "ckpt"), "inputs": inputs,
            "volume": list(VOLUME), "mask": str(work / "http_mask.npy"), "work": str(work)}
    torch.cuda.empty_cache()
    by_path["explain"] = phase_explain()
    torch.cuda.empty_cache()
    phase_analysis(analysis_case)
    torch.cuda.empty_cache()
    phase_preprocess()
    torch.cuda.empty_cache()
    by_path["multi"] = phase_multi(http)
    shutil.rmtree(work)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, s in summary.items():
        paths = {path: counts[name] for path, counts in by_path.items() if name in counts}
        if not paths or not all(launch_count(c) for c in paths.values()):
            raise SystemExit(f"kernel {name} was not launched on every path that runs it: {paths}")
        kernels.append(dict(name=name, launches=sum(launch_count(c) for c in paths.values()),
                            launches_by_path=paths, **s))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
