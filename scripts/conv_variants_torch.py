#!/usr/bin/env python3
"""Where kernel C's time goes: the bf16 ``wgmma`` route of
``csrc/conv3x3x3.cu`` against variants of itself, built from the same
source with one part cut out, timed in turns at the two decoder shapes.

- ``kernel``: the source as it is;
- ``products_only``: the producer copies nothing (it only arrives on the
  full barriers), so the ring never waits for memory; the output is garbage;
- ``loads_only``: the consumers issue no ``wgmma``; the output is garbage;
- ``no_stores``: the epilogue rounds the sums but stores (almost) nothing.

A variant that is as slow as ``kernel`` shows the part it removed was
hidden. Times are CUDA-event means over ``--reps`` calls, in the order
kernel, variants, variants reversed, kernel; each line names the card, its
power limit and its SM clock.

Run: python scripts/conv_variants_torch.py [--reps N]
Needs a CUDA device and nvcc; exits with code 2 without a device.
"""

import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from scripts.proto_conv_kernel_torch import BATCH, SHAPES_BF16, conv_bound_ms, event_ms, make_inputs

LOADS = """        tma_load_5d(st, &xmap, full(s), cc * kChunk, zw, zh, zd, b);
        tma_load_5d(st + kGroupBytes, &xmap, full(s), cc * kChunk + 8, zw, zh, zd, b);
        bulk_load(st + 2 * kGroupBytes, wsrc + static_cast<long long>(cc) * (kWBytes / 2), kWBytes,
                  full(s));
"""
EXPECT_TX = "mbar_arrive_expect_tx(full(s), kStageBytes);"
PRODUCT = "wgmma_m64n48k16(acc[m], wgmma_desc(a, kGroupBytes, kHaloEdge * 16), db, scale_d);"
STORE = "if (n0 + 8 * j < Cout) o[4 * j] = packed[m][2 * j + r];"
# (text, replacement) pairs; each text must occur in the source
VARIANTS = {
    "kernel": [],
    "products_only": [(LOADS, "        (void)wsrc; (void)zw; (void)zh; (void)zd; (void)b;\n"),
                      (EXPECT_TX, "mbar_arrive(full(s));")],
    "loads_only": [(PRODUCT, "(void)a; (void)db; (void)scale_d;")],
    "no_stores": [(STORE, "if (n0 + 8 * j < Cout && packed[m][2 * j + r] == 0x7fc17fc1u) o[4 * j] = 0;")],
}


def variant_libraries(root: Path) -> dict:
    """Build each variant's library under ``root/<name>`` with the port's
    own build (same flags, same headers); returns ``{name: ctypes library}``."""
    from multimodal_organ_segmentation_tpu_torch.ops import _build, conv3d

    source = (_build.CSRC / "conv3x3x3.cu").read_text()
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    libs = {}
    try:
        for name, edits in VARIANTS.items():
            text = source
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"variant {name}: the source no longer holds {old.strip()!r}")
                text = text.replace(old, new)
            shutil.rmtree(root / name, ignore_errors=True)
            shutil.copytree(csrc, root / name / "csrc")
            (root / name / "csrc" / "conv3x3x3.cu").write_text(text)
            _build.CSRC, _build.BUILD_DIR = root / name / "csrc", root / name
            _build._libs.pop("conv3x3x3", None)
            libs[name] = _build.load("conv3x3x3", conv3d._SIGNATURES)
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._libs.pop("conv3x3x3", None)
    return libs


def main(argv):
    if not torch.cuda.is_available():
        print("conv_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    from multimodal_organ_segmentation_tpu_torch.ops import _build
    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3

    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 10
    libs = variant_libraries(_build.BUILD_DIR / "variants")

    def card():
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()

    names = list(VARIANTS)
    order = names + names[::-1]
    try:
        for cin, cout in SHAPES_BF16:
            shape = (BATCH, 96, 96, 96, cin)
            x, w = make_inputs(shape, cout, torch.bfloat16, 1, 0.05)
            bound, by = conv_bound_ms(shape, cout, torch.bfloat16)
            times = {name: [] for name in names}
            for name in order:
                _build._libs["conv3x3x3"] = libs[name]
                times[name].append(event_ms(lambda: conv3x3x3(x, w), reps))
            for name in names:
                mean = sum(times[name]) / len(times[name])
                print(f"{name:14s} {cin}->{cout}: ms {[round(t, 4) for t in times[name]]} mean "
                      f"{mean:.4f} ({100 * bound / mean:.1f}% of the {bound:.3f} ms {by} bound) "
                      f"[{card()}]", flush=True)
            del x, w
    finally:
        _build._libs.pop("conv3x3x3", None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
