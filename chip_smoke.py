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
   the training shapes (forward + backward through their
   ``autograd.Function``s against autograd of the plain versions), the
   convolution at its script's shapes;
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
   ``--profile`` adds a profiler pass over one train step.

The line before the last holds one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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

# Published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, and the exponentials of the
# special-function units (16 a clock per SM, 132 SMs, 1.98 GHz).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
EXP_S = 16 * 132 * 1.98e9

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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_time(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, each after the L2 is
    overwritten (the main path finds the kernel's inputs cold)."""
    import torch

    fn()  # warm-up
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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
    """Set every route's count of the attention wrappers to 0."""
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
                                 replaces="multimodal_organ_segmentation_tpu/ops/pallas/window_attention.py:166"),
        "flash_attention": dict(route="cuda",
                                source="multimodal_organ_segmentation_tpu_torch/csrc/flash_attention.cu",
                                replaces="multimodal_organ_segmentation_tpu/ops/pallas/flash_attention.py:138"),
        "conv3x3x3": dict(route="cuda",
                          source="multimodal_organ_segmentation_tpu_torch/csrc/conv3x3x3.cu",
                          replaces="scripts/proto_conv_kernel.py:103"),
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
    kernels_conv(record, flush)
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


def kernels_conv(record, flush) -> None:
    """Kernel C against ``conv3x3x3_plain`` at its script's three shapes. The
    weights are scaled so that the outputs stay below 2, where one bf16 ulp
    is 7.8e-3 and the absolute bf16 tolerance of 2e-2 means two ulp."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, conv3x3x3_plain
    from scripts.proto_conv_kernel_torch import SHAPES_BF16, library_conv, make_inputs

    cases = [((2, 16, 16, 16, 8), 8, torch.float32)]
    cases += [((8, 96, 96, 96, cin), cout, torch.bfloat16) for cin, cout in SHAPES_BF16]
    for shape, cout, dtype in cases:
        dname = str(dtype).split(".")[1]
        cin = shape[-1]
        x, w = make_inputs(shape, cout, dtype, 2, 0.3 / math.sqrt(27 * cin))
        out = conv3x3x3(x, w)
        torch.cuda.synchronize()
        ref = conv3x3x3_plain(x, w)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        del out, ref
        ms = gpu_time(lambda: conv3x3x3(x, w), 5, flush)
        plain_ms = gpu_time(lambda: conv3x3x3_plain(x, w), 2, flush)
        lib_ms = gpu_time(lambda: library_conv(x, w), 5, flush)
        voxels = math.prod(shape[:4])
        elt = torch.finfo(dtype).bits // 8
        nbytes = (voxels * (cin + cout) + 27 * cin * cout) * elt
        flops = 2 * 27 * voxels * cin * cout
        record("conv3x3x3", dname, err, ms, plain_ms, lib_ms, nbytes, flops, 0,
               f"x {list(shape)} -> {cout} max |out| {top:.2f}")
        del x, w
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

    def compare(name, dname, extra, out, ref, grads, ref_grads, fwd_ms, bwd_ms):
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
        if dname == "bfloat16":
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
        for stage, b, n, heads, d in flash_shapes(micro):
            q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), np.float32))
                       .to(dev, dtype).requires_grad_() for _ in range(3))
            out = flash_attention(q, k, v)
            go = torch.from_numpy(rng.standard_normal(tuple(out.shape), np.float32)).to(dev, dtype)
            grads = torch.autograd.grad(out, [q, k, v], go)
            ref = blockwise_attention(q, k, v, kv_block=2048)
            ref_grads = torch.autograd.grad(ref, [q, k, v], go)
            torch.cuda.synchronize()
            with torch.no_grad():
                fwd_ms = gpu_time(lambda: flash_attention(q, k, v), 10, flush)
            bwd_ms = grad_time(lambda: flash_attention(q, k, v), [q, k, v], go, 5, flush)
            compare("flash_attention", dname, f"/{2 ** (stage + 2)} B={b} N={n} H={heads} D={d}",
                    out, ref, grads, ref_grads, fwd_ms, bwd_ms)


def phase_model() -> None:
    """One 96³ tile through the flagship model, through the kernels and
    through the plain versions: in f32 (TF32 off) and in bf16, the serving
    type. Labels must agree on every voxel whose top-2 logit margin is above
    twice the logit tolerance."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 96, 96, 96, 2), np.float32)).cuda()
    for precision, tol in (("fp32", MODEL_TOL), ("bf16", MODEL_TOL_BF16)):
        cfg = json.loads(json.dumps(FLAGSHIP))
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
        log(f"[model] flagship {precision}, one 96^3 tile: max |logit kernels - plain| {err:.3e} "
            f"(tol {tol:.0e}; largest |logit| {plain.abs().max().item():.2f}), label agreement "
            f"{agree:.6f}, all labels agree where the top-2 margin > {2 * tol:.0e} "
            f"({clear.float().mean().item():.4f} of voxels): {agree_clear}")
        if not (torch.isfinite(kern).all() and err <= tol and agree_clear):
            raise SystemExit(f"the {precision} model through the kernels disagrees with the plain versions")
        del model, kern, plain
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


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
    launches = {"window_attention": dict(window_mha.launches),
                "flash_attention": dict(flash_attention.launches)}
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
    return launches


def phase_conv() -> dict:
    """Kernel C's own path: the conv script's two stages (f32 check, bf16
    checks and times at the two decoder shapes)."""
    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3
    from scripts import proto_conv_kernel_torch as conv_script

    conv3x3x3.launches = 0
    if conv_script.main([]) != 0:
        raise SystemExit("the conv script failed")
    launches = conv3x3x3.launches
    # 1 f32 launch; per bf16 shape 1 checked launch, 1 warm-up and 5 timed ones
    expect = 1 + len(conv_script.SHAPES_BF16) * 7
    log(f"[conv] kernels {json.dumps({'conv3x3x3': launches})} expected {expect}")
    if launches != expect:
        raise SystemExit("the conv script's kernel launches differ from the count the code predicts")
    return {"conv3x3x3": launches}


def training_patches(n: int, seed: int):
    """``n`` synthetic 96³ CT+PET patches with 8-class labels from a numpy
    seed, standardised per channel (the transform graph that normalises real
    volumes is not ported yet)."""
    from multimodal_organ_segmentation_tpu_torch.data.synthetic import synthetic_volume

    rng = np.random.default_rng(seed)
    size = tuple(FLAGSHIP["model"]["backbone"]["img_size"])
    batches = []
    for _ in range(n):
        image, label = synthetic_volume(size, FLAGSHIP["model"]["out_channels"], rng)
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
    launches = {"window_attention": dict(window_mha.launches),
                "flash_attention": dict(flash_attention.launches)}
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
    by_path = {"serve": phase_serve(profile)}
    torch.cuda.empty_cache()
    by_path["conv"] = phase_conv()
    torch.cuda.empty_cache()
    by_path["train"] = phase_train(profile)
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
