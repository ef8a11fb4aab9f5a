"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; no phase's error is caught):

1. build   — compile every CUDA kernel under
   ``multimodal_organ_segmentation_tpu_torch/csrc/`` with nvcc (one
   process per source, all started together) into ``build/kernels/``;
2. kernels — at every shape the main path gives each kernel, in bf16 and
   f32, the kernel against its plain PyTorch version on the same inputs,
   with the kernel's, the plain version's and one PyTorch library call's
   time (``F.scaled_dot_product_attention``, a yardstick the port never
   calls) beside the least time the card could take (``bound``);
3. model   — one 96³ tile through the flagship model in f32 (TF32 off),
   once through the kernels and once through the plain versions;
4. serve   — the main path at full width: ``build_model`` of the flagship
   config (bf16, seeded init), then sliding-window inference
   (ROI 96³, overlap 0.5, Gaussian blend, 15 tiles a chunk) and
   ``predict_labels`` over one warm-up and three 192×192×256×2 volumes,
   with each kernel's launches counted and held to the count the code
   predicts. ``--profile`` adds a profiler pass over one more volume and
   prints the device time by kernel.

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
# dict: the card's machine needs no PyYAML. A CPU test holds the ``model``
# and ``inference`` blocks equal to the file's.
FLAGSHIP = {
    "experiment": {"name": "swin_xattn_flagship", "seed": 42},
    "data": {"modalities": ["CT", "PET"]},
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
    "hardware": {"mixed_precision": "bf16"},
}
VOLUME = (192, 192, 256)
N_VOLUMES = 3

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
MODEL_TOL = 1e-3  # f32 logits after ~40 layers, each off by ~1e-6 relative


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


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from multimodal_organ_segmentation_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} of {len(_build.SOURCES)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def window_shapes():
    """Kernel A's launches for one chunk of 15 tiles: (stage, BW, heads,
    nW per tile or None) for each Swin block, unshifted then shifted."""
    model = FLAGSHIP["model"]["backbone"]
    tiles = FLAGSHIP["inference"]["batch_size"]
    grid = model["img_size"][0] // 2
    win = model["window_size"][0]
    for stage, heads in enumerate(model["num_heads"]):
        w = min(win, grid)
        nw = (grid // w) ** 3
        for block in range(model["depths"][stage]):
            shifted = block % 2 == 1 and w < grid
            yield stage, tiles * nw, heads, (nw if shifted else None), grid, w
        grid //= 2


def flash_shapes():
    """Kernel B's launches for one chunk: (stage, B, N, heads, head dim)."""
    model = FLAGSHIP["model"]
    fs = model["backbone"]["feature_size"]
    tiles = FLAGSHIP["inference"]["batch_size"]
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import _divisor_heads

    for stage in model["fusion"]["stages"]:
        c = fs * 2 ** (stage + 1)
        grid = model["backbone"]["img_size"][0] // 2 ** (stage + 2)
        heads = _divisor_heads(c, 96)
        yield stage, tiles, grid**3, heads, c // heads


def phase_kernels(flush) -> dict:
    import torch
    import torch.nn.functional as F

    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import _shift_attention_mask
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
    }
    for s in summary.values():
        s.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, _bytes=0.0, _ops=0.0)

    def record(name, dtype, err, ms, plain_ms, lib_ms, nbytes, flops, extra):
        t_bound, by = bound(nbytes, flops, dtype)
        ok = err <= TOL[dtype]
        log(f"[kernels] {name} {extra} {dtype}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {t_bound:.4f} "
            f"({by}) {'ok' if ok else 'FAIL'}")
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

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        elt = torch.finfo(dtype).bits // 8
        for stage, bw, heads, nw, grid, w in window_shapes():
            n, d = w**3, 16
            qkv = torch.from_numpy(rng.standard_normal((bw, n, 3, heads, d), np.float32))
            qkv = qkv.to(dev, dtype)
            q, k, v = qkv.unbind(2)  # strided views, as the model hands them over
            bias = torch.from_numpy(0.5 * rng.standard_normal((heads, n, n), np.float32)).to(dev)
            mask = None
            if nw is not None:
                mask = _shift_attention_mask((grid,) * 3, (w,) * 3, (w // 2,) * 3, dev)
            nw_arg = nw or 1
            out = window_mha(q, k, v, bias, mask, nw_arg)
            ref = dense_window_mha(q, k, v, bias, mask, nw_arg)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            del ref
            ms = gpu_time(lambda: window_mha(q, k, v, bias, mask, nw_arg), 10, flush)
            plain_ms = gpu_time(lambda: dense_window_mha(q, k, v, bias, mask, nw_arg), 3, flush)
            add = bias[None] if mask is None else (mask[:, None] + bias[None])
            add = add.to(dtype).repeat(bw // add.shape[0], 1, 1, 1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add), 5, flush)
            del add, qt, kt, vt
            nbytes = 4 * bw * n * heads * d * elt + heads * n * n * 4 + (nw * n * n * 4 if nw else 0)
            flops = 4 * bw * heads * n * n * d
            exp_ms = bw * heads * n * n / EXP_S * 1e3
            record("window_attention", dname, err, ms, plain_ms, lib_ms, nbytes, flops,
                   f"stage {stage} BW={bw} N={n} H={heads} D={d} mask={'yes' if nw else 'no'} "
                   f"exp_bound_ms {exp_ms:.4f}")
        for stage, b, n, heads, d in flash_shapes():
            q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), np.float32)).to(dev, dtype)
                       for _ in range(3))
            out = flash_attention(q, k, v)
            ref = blockwise_attention(q, k, v, kv_block=2048)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ms = gpu_time(lambda: flash_attention(q, k, v), 10, flush)
            plain_ms = gpu_time(lambda: blockwise_attention(q, k, v, kv_block=2048), 3, flush)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5, flush)
            nbytes = 4 * b * n * heads * d * elt
            flops = 4 * b * heads * n * n * d
            exp_ms = b * heads * n * n / EXP_S * 1e3
            record("flash_attention", dname, err, ms, plain_ms, lib_ms, nbytes, flops,
                   f"/{2 ** (stage + 2)} B={b} N={n} H={heads} D={d} exp_bound_ms {exp_ms:.4f}")
    for s in summary.values():
        s["bound_ms"], s["bound_by"] = bound(s.pop("_bytes"), s.pop("_ops"), "bfloat16")
    return summary


def phase_model() -> None:
    import torch

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import set_use_kernels

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["hardware"]["mixed_precision"] = "fp32"
    model = build_model(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 96, 96, 96, 2), np.float32)).cuda()
    with torch.no_grad():
        kern = model(x)
        set_use_kernels(model, False)
        plain = model(x)
    torch.cuda.synchronize()
    err = (kern - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * MODEL_TOL
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    agree_clear = (kern.argmax(-1) == plain.argmax(-1))[clear].all().item()
    log(f"[model] flagship f32, one 96^3 tile: max |logit kernels - plain| {err:.3e} "
        f"(tol {MODEL_TOL:.0e}), label agreement {agree:.6f}, all labels agree where the "
        f"top-2 margin > {2 * MODEL_TOL:.0e} ({clear.float().mean().item():.4f} of voxels): {agree_clear}")
    if not (torch.isfinite(kern).all() and err <= MODEL_TOL and agree_clear):
        raise SystemExit("the model through the kernels disagrees with the plain versions")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del model


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
    blocks = sum(FLAGSHIP["model"]["backbone"]["depths"])
    fusions = len(FLAGSHIP["model"]["fusion"]["stages"])
    expect = {"window_attention": blocks * chunks * (N_VOLUMES + 1),
              "flash_attention": fusions * chunks * (N_VOLUMES + 1)}

    window_mha.launches = 0
    flash_attention.launches = 0
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
    launches = {"window_attention": window_mha.launches, "flash_attention": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    mean = sum(times) / len(times)
    log(f"[serve] volume {VOLUME}x2, {chunks} chunks of {sw_batch} tiles: per-volume ms "
        f"{[round(t, 1) for t in times]}, mean {mean:.1f} ms, {60e3 / mean:.2f} volumes/min, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve] kernels {json.dumps(launches)} expected {json.dumps(expect)}")
    if launches != expect:
        raise SystemExit("the main path's kernel launches differ from the count the code predicts")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        def device_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        # device-side rows only: the CPU operators' rows repeat their kernels' time
        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve(volumes[1])
        wall_ms = (time.perf_counter() - t0) * 1e3
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                        key=lambda e: -device_us(e))
        total = sum(device_us(e) for e in events)
        if not total:
            log("[profile] the profiler recorded no device time: not measured")
            return launches
        log(f"[profile] one volume: device time {total / 1e3:.1f} ms over {wall_ms:.1f} ms of "
            f"wall time under the profiler (busy {100 * total / 1e3 / wall_ms:.1f}%), by kernel (top 25):")
        for e in events[:25]:
            t = device_us(e)
            log(f"[profile]   {t / 1e3:9.2f} ms {100 * t / total:5.1f}% x{e.count:<5d} {e.key[:90]}")

        # the same volume through the plain versions, for the dispatch a
        # later change may set from these numbers
        set_use_kernels(model, False)
        serve(volumes[1])
        t0 = time.perf_counter()
        serve(volumes[1])
        log(f"[profile] one volume through the plain versions: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        set_use_kernels(model, True)
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
    launches = phase_serve("--profile" in argv)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(name=name, launches=launches[name], **s) for name, s in summary.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
