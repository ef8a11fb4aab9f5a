"""Kernels A and B on the card: each route, and throwaway variants of their
CUDA sources that tell where the time goes.

    python3 scripts/attention_variants.py

Needs one CUDA device (exits with code 2 without one). Each variant is the
kernel's source under ``multimodal_organ_segmentation_tpu_torch/csrc/`` with
one text substitution (``VARIANTS`` below), built by nvcc into
``build/variants/`` (git-ignored) and launched through the same C entry as
the real library, on the plan of the wrapper's route. Outputs are checked
against the plain version only for the real routes: a variant that drops
the exponentials or the bias computes another function and is timed only.

Kernel A, at the flagship's serving chunk (15 tiles, each Swin block):
the ``mma`` route, the same with ``ex2`` replaced by a multiply and with the
bias and mask add removed; the ``wgmma`` route, the same with ``ex2``
replaced by a multiply and without the staging of the bias. Kernel B, at
the flagship's fusions and the DualEncoders' attending levels: the
``wgmma`` route as built (the softmax-bound schedule up to D = 64, the plain
one above), with the plain schedule at every head dim, with the overlapped
one at every head dim, and overlapped without the ping-pong; the ``mma``
route; ``F.scaled_dot_product_attention``. Times are device ms from
``chip_smoke.gpu_time`` (the L2 flushed before each call).
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MMA_EXP = ("mma.cuh", "s[n][e] = fast_exp2(s[n][e] - base[e >> 1]);",
           "s[n][e] = (s[n][e] - base[e >> 1]) * 0.5f;")
MMA_BIAS = ("window_attention.cu", """          const float2 b0 =
              __half22float2(*reinterpret_cast<const __half2*>(bm_g + c0 + 8 * nt));
          const float2 b1 = __half22float2(
              *reinterpret_cast<const __half2*>(bm_g + 8 * bm_stride + c0 + 8 * nt));
          s[nt][0] = fmaf(s[nt][0], scale_log2, b0.x);
          s[nt][1] = fmaf(s[nt][1], scale_log2, b0.y);
          s[nt][2] = fmaf(s[nt][2], scale_log2, b1.x);
          s[nt][3] = fmaf(s[nt][3], scale_log2, b1.y);""", """          s[nt][0] *= scale_log2;
          s[nt][1] *= scale_log2;
          s[nt][2] *= scale_log2;
          s[nt][3] *= scale_log2;""")
WGMMA_EXP = ("window_attention.cu",
             "for (int e = 0; e < 4; ++e) t[e] = fast_exp2(t[e] - base_r[e >> 1]);",
             "for (int e = 0; e < 4; ++e) t[e] = (t[e] - base_r[e >> 1]) * 0.5f;")
WGMMA_STAGING = ("window_attention.cu",
                 "stage_bias<NT8, KPAD, BS>(bm, bias_h, mask_w, n, threadIdx.x, kWgConsumers);",
                 "")
PLAIN_EVERYWHERE = ("flash_attention.cu", "constexpr int kWgOverlapMaxD = 64;",
                    "constexpr int kWgOverlapMaxD = 0;")
OVERLAP_EVERYWHERE = ("flash_attention.cu", "constexpr int kWgOverlapMaxD = 64;",
                      "constexpr int kWgOverlapMaxD = 128;")
NO_PINGPONG = [("flash_attention.cu", "      named_barrier_sync(1 + wg, 2 * 128);\n", ""),
               ("flash_attention.cu",
                "      if (wg == 0 || j + 1 < tiles) named_barrier_arrive(2 - wg, 2 * 128);\n", ""),
               ("flash_attention.cu",
                "    if (wg == 1 && tiles > 1) named_barrier_arrive(1, 2 * 128);\n", "")]
VARIANTS = {
    "window_attention": {"ex2 as a multiply (mma)": [MMA_EXP], "no bias add (mma)": [MMA_BIAS],
                         "ex2 as a multiply (wgmma)": [WGMMA_EXP],
                         "no bias staging (wgmma)": [WGMMA_STAGING]},
    "flash_attention": {"plain schedule at every D": [PLAIN_EVERYWHERE],
                        "overlap + ping-pong at every D": [OVERLAP_EVERYWHERE],
                        "overlap, no ping-pong, at every D": [OVERLAP_EVERYWHERE, *NO_PINGPONG]},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_variants() -> dict:
    """Every variant of ``VARIANTS`` built from csrc/ with its edits applied,
    one nvcc each, all started together: ``{(kernel, label): CDLL}``."""
    from multimodal_organ_segmentation_tpu_torch.ops import _build

    running = {}
    for name, variants in VARIANTS.items():
        for label, edits in variants.items():
            slug = "".join(c if c.isalnum() else "_" for c in label)
            out = ROOT / "build" / "variants" / f"{name}_{slug}"
            out.mkdir(parents=True, exist_ok=True)
            for src in _build.CSRC.iterdir():
                text = src.read_text()
                for fname, old, new in edits:
                    if src.name == fname:
                        if old not in text:
                            raise SystemExit(f"variant {label!r}: {fname} no longer holds "
                                             f"{old[:60]!r}")
                        text = text.replace(old, new)
                (out / src.name).write_text(text)
            lib_path = out / f"{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(out / f"{name}.cu")]
            running[(name, label)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True), lib_path)
    libs = {}
    for key, (proc, lib_path) in running.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {key} failed to build:\n{text[-3000:]}")
        libs[key] = ctypes.CDLL(str(lib_path))
    return libs


def bind(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def window_call(lib, route, q, k, v, bias, mask, nw, out):
    """One launch of kernel A's ``route`` from ``lib`` on the wrapper's plan."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops import window_attention as wa

    bw, n, h, d = q.shape
    p = wa.plan(bw, n, h, d, nw, q.dtype, route=route)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(), bw, n, h, d, nw,
            d**-0.5 * math.log2(math.e))
    stream = torch.cuda.current_stream().cuda_stream
    if route == "wgmma":
        err = lib.window_mha_fwd_wgmma(*args, p["tiles_per_block"], p["stages"], *p["grid"],
                                       p["threads"], p["smem"], 0, stream)
    else:
        err = lib.window_mha_fwd_mma(*args, p["threads"] // 32, p["tiles_per_block"], *p["grid"],
                                     p["smem"], 0, stream)
    if err:
        raise SystemExit(f"window_attention {route}: CUDA error {err}")


def flash_call(lib, route, q, k, v, out):
    """One launch of kernel B's ``route`` from ``lib`` on the wrapper's plan."""
    import torch

    from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as fa

    b, nq, h, d = q.shape
    nk = k.shape[1]
    p = fa.plan(b, nq, nk, h, d, q.dtype, route=route)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk, h, d,
            d**-0.5 * math.log2(math.e))
    stream = torch.cuda.current_stream().cuda_stream
    if route == "wgmma":
        err = lib.flash_attention_fwd_wgmma(*args, *p["grid"], p["threads"], p["smem"],
                                            p["stages"], 0, stream)
    else:
        err = lib.flash_attention_fwd_mma(*args, *p["grid"], p["smem"], 0, stream)
    if err:
        raise SystemExit(f"flash_attention {route}: CUDA error {err}")


def kernel_a(flush, built) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from multimodal_organ_segmentation_tpu_torch.ops import _build
    from multimodal_organ_segmentation_tpu_torch.ops import window_attention as wa

    real = _build.load("window_attention", wa._SIGNATURES)
    variants = {label: bind(built[("window_attention", label)], wa._SIGNATURES)
                for label in VARIANTS["window_attention"]}
    runs = [("mma", "mma", real), ("wgmma", "wgmma", real)]
    runs += [(label, "mma" if "(mma)" in label else "wgmma", lib) for label, lib in variants.items()]
    rng = np.random.default_rng(7)
    totals = dict.fromkeys([r[0] for r in runs] + ["sdpa"], 0.0)
    for stage, bw, heads, nw, grid, w in chip_smoke.window_shapes():
        n = w**3
        q, k, v, bias, mask, _ = chip_smoke.window_inputs(rng, "cuda", torch.bfloat16, bw, n, heads,
                                                          grid, w, nw is not None)
        nw_arg = nw or 1
        out = torch.empty((bw, n, heads, 16), dtype=torch.bfloat16, device="cuda")
        ref = wa.dense_window_mha(q, k, v, bias, mask, nw_arg).float()
        row = {}
        for label, route, lib in runs:
            row[label] = chip_smoke.gpu_time(
                lambda: window_call(lib, route, q, k, v, bias, mask, nw_arg, out), 10, flush)
            if lib is real:
                err = (out.float() - ref).abs().max().item()
                if err > chip_smoke.TOL["bfloat16"]:
                    raise SystemExit(f"window_attention {route} stage {stage}: error {err:.3e}")
        add = bias[None] if mask is None else (mask[:, None] + bias[None])
        add = add.to(torch.bfloat16).repeat(bw // add.shape[0], 1, 1, 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa"] = chip_smoke.gpu_time(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add), 5, flush)
        log(f"[variants] window_attention stage {stage} BW={bw} H={heads} "
            f"mask={'yes' if nw else 'no'}: " + "; ".join(f"{k} {v:.4f}" for k, v in row.items()))
        for key in totals:
            totals[key] += row[key]
        del q, k, v, bias, mask, out, ref, add, qt, kt, vt
    log("[variants] window_attention serving chunk: "
        + "; ".join(f"{k} {v:.4f}" for k, v in totals.items()))


def kernel_b(flush, built) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from multimodal_organ_segmentation_tpu_torch.ops import _build
    from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as fa
    from multimodal_organ_segmentation_tpu_torch.ops.attention import blockwise_attention

    real = _build.load("flash_attention", fa._SIGNATURES)
    variants = {label: bind(built[("flash_attention", label)], fa._SIGNATURES)
                for label in VARIANTS["flash_attention"]}
    runs = [("wgmma as built", "wgmma", real), ("mma", "mma", real)]
    runs += [(label, "wgmma", lib) for label, lib in variants.items()]
    shapes = [(f"/{2 ** (stage + 2)}", b, n, h, d) for stage, b, n, h, d in chip_smoke.flash_shapes()]
    for key in (chip_smoke.DE128, "full_pipeline_4mod"):
        cfg = chip_smoke.model_config(key)
        shapes += [(f"{key} level {level}", b, n, h, d) for level, b, n, h, d in
                   chip_smoke.dual_encoder_flash_shapes(cfg, cfg["inference"]["batch_size"])]
    rng = np.random.default_rng(8)
    for where, b, n, h, d in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d), np.float32)).to(
            "cuda", torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        ref = blockwise_attention(q, k, v, kv_block=2048).float()
        row = {}
        for label, route, lib in runs:
            flash_call(lib, route, q, k, v, out)
            err = (out.float() - ref).abs().max().item()
            if err > chip_smoke.TOL["bfloat16"]:
                raise SystemExit(f"flash_attention {label} at {where}: error {err:.3e}")
            row[label] = chip_smoke.gpu_time(lambda: flash_call(lib, route, q, k, v, out), 10, flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa"] = chip_smoke.gpu_time(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10,
                                          flush)
        log(f"[variants] flash_attention {where} [{b},{n},{h},{d}]: "
            + "; ".join(f"{k} {v:.4f}" for k, v in row.items()))
        del q, k, v, out, ref, qt, kt, vt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[variants] {smi}")
    from multimodal_organ_segmentation_tpu_torch.ops import _build

    _build.build(("window_attention", "flash_attention"))
    built = build_variants()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_a(flush, built)
    kernel_b(flush, built)
    return 0


if __name__ == "__main__":
    sys.exit(main())
