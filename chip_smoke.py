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
   tensors, the masks equal, the CSV and XLSX columns the JAX tables'.

The line before the last holds one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

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
    shutil.rmtree(work)
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
    torch.cuda.empty_cache()
    by_path["explain"] = phase_explain()
    torch.cuda.empty_cache()
    phase_analysis(analysis_case)
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
